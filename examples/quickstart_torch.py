"""Quickstart on the PyTorch port: pre-process two sets, intersect them
every way the paper defines, and verify against the oracle.

The twin of ``examples/quickstart.py``: the same sets, algorithms and
claims, through ``repro_torch``.  The device engine runs on
``--torch-device`` (default ``cuda``: the hand-written CUDA kernels;
``cpu``: their plain PyTorch versions).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--torch-device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.engine import DeviceSet, intersect_device
from repro_torch.core.hashing import default_permutation, random_hash_family
from repro_torch.core.intersect import hashbin, intgroup, rangroup, rangroupscan
from repro_torch.core.partition import preprocess_fixed, preprocess_prefix


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch-device", default="cuda",
                    help="where the device engine runs: cuda (default) or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    universe = 1 << 26
    common = rng.choice(universe, 500, replace=False).astype(np.uint32)
    a = np.unique(
        np.concatenate([rng.choice(universe, 40000).astype(np.uint32), common]))
    b = np.unique(
        np.concatenate([rng.choice(universe, 90000).astype(np.uint32), common]))
    truth = np.intersect1d(a, b)
    print(f"|A|={len(a)}  |B|={len(b)}  |A∩B|={len(truth)}")

    # shared pre-processing (Section 3.3): g-partition + m hash images
    fam = random_hash_family(m=2, w=256, seed=1)
    perm = default_permutation(seed=1)
    ia = preprocess_prefix(a, w=256, m=2, family=fam, perm=perm)
    ib = preprocess_prefix(b, w=256, m=2, family=fam, perm=perm)

    res, st = rangroupscan([ia, ib])
    assert np.array_equal(res, truth)
    print(f"RanGroupScan: r={st.r}  groups={st.group_tuples} "
          f"filtered={st.tuples_filtered} ({100*st.filter_rate:.1f}%)")

    res, st = rangroup([ia, ib])
    assert np.array_equal(res, truth)
    print(f"RanGroup:     r={st.r}  survivors={st.tuples_survived}")

    res, st = hashbin(ia, ib)
    assert np.array_equal(res, truth)
    print(f"HashBin:      r={st.r}  comparisons={st.comparisons}")

    f64 = random_hash_family(m=1, w=64, seed=2)
    fa = preprocess_fixed(a, w=64, family=f64)
    fb = preprocess_fixed(b, w=64, family=f64)
    res, st = intgroup(fa, fb)
    assert np.array_equal(res, truth)
    print(f"IntGroup:     r={st.r}  pairs={st.group_tuples} "
          f"filtered={st.tuples_filtered}")

    # device engine (CUDA kernels on the card; their plain versions on cpu)
    dev = args.torch_device
    res, stats = intersect_device(
        [DeviceSet.from_host(ia, device=dev), DeviceSet.from_host(ib, device=dev)],
        device=dev)
    assert np.array_equal(res, truth)
    print(f"Device engine ({dev}): r={stats['r']} "
          f"survivors={stats['tuples_survived']}/{stats['group_tuples']}")
    print("all results match the oracle ✓")
    return {"truth": truth, "device_result": res, "device_stats": stats}


if __name__ == "__main__":
    main()
