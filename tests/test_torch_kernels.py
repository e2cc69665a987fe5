"""The port's kernel modules on the CPU.

The plain PyTorch versions (``repro_torch.kernels.ref``) are held against
the JAX package's jnp references and against its Pallas kernels run in
interpret mode, on the same numpy inputs and over the grid of
``tests/test_kernels.py``; outputs must be equal (tolerance 0).  The CUDA
wrappers must refuse CPU tensors, and the router must send CPU tensors to
the plain versions without touching the kernels.  ``compact_rows``, which
the JAX package has no counterpart of, is held against a numpy oracle.  The CUDA kernels
themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_rows import padded_rows
from repro.kernels import ref as jref
from repro.kernels.bitmap_filter import bitmap_filter_pallas
from repro.kernels.group_intersect import group_match_pallas

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.bitmap_filter import bitmap_filter_cuda
from repro_torch.kernels.compact import compact_rows_cuda
from repro_torch.kernels.group_intersect import group_match_cuda


def as_torch(x: np.ndarray) -> torch.Tensor:
    """uint32 images travel as int32 bit patterns, as on the device."""
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def check_filter(imgs: np.ndarray, pallas: bool = True) -> np.ndarray:
    out = ref.bitmap_filter_ref(as_torch(imgs)).numpy()
    assert out.dtype == np.bool_
    np.testing.assert_array_equal(out, np.asarray(
        jref.bitmap_filter_ref(jnp.asarray(imgs))))
    if pallas:
        np.testing.assert_array_equal(out, np.asarray(
            bitmap_filter_pallas(jnp.asarray(imgs), interpret=True)))
    np.testing.assert_array_equal(out, ops.bitmap_filter(as_torch(imgs)).numpy())
    return out


def check_match(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = ref.group_match_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert out.dtype == np.bool_
    np.testing.assert_array_equal(out, np.asarray(
        jref.group_match_ref(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(out, np.asarray(
        group_match_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)))
    np.testing.assert_array_equal(
        out, ops.group_match(torch.from_numpy(a), torch.from_numpy(b)).numpy())
    return out


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("G", [1, 7, 128, 1000])
@pytest.mark.parametrize("m,W", [(1, 2), (2, 8), (3, 4), (4, 2)])
def test_bitmap_filter_sweep(k, G, m, W):
    rng = np.random.default_rng(k * 1000 + G + m * 10 + W)
    imgs = rng.integers(0, 1 << 32, size=(k, G, m, W),
                        dtype=np.uint64).astype(np.uint32)
    imgs[rng.random((k, G, m, W)) < 0.6] = 0
    check_filter(imgs)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
def test_bitmap_filter_dtypes(dtype):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 1 << 31, size=(2, 64, 2, 8),
                        dtype=np.int64).astype(dtype)
    check_filter(imgs)


def test_bitmap_filter_all_pass_all_fail():
    ones = np.full((3, 32, 2, 4), 0xFFFFFFFF, dtype=np.uint32)
    assert check_filter(ones).all()
    zeros = np.zeros((3, 32, 2, 4), dtype=np.uint32)
    assert not check_filter(zeros).any()


@pytest.mark.parametrize("B", [1, 3, 9])
@pytest.mark.parametrize("G", [7, 128, 300])
def test_bitmap_filter_batched(B, G):
    rng = np.random.default_rng(B * 17 + G)
    imgs = rng.integers(0, 1 << 32, size=(B, 3, G, 2, 8),
                        dtype=np.uint64).astype(np.uint32)
    imgs[rng.random(imgs.shape) < 0.6] = 0
    out = check_filter(imgs)
    assert out.shape == (B, G)
    for b in range(B):
        np.testing.assert_array_equal(
            out[b], ref.bitmap_filter_ref(as_torch(imgs[b])).numpy())


@pytest.mark.parametrize("S", [1, 8, 57, 256])
@pytest.mark.parametrize("ga,gb", [(8, 8), (16, 32), (40, 16), (128, 128)])
def test_group_match_sweep(S, ga, gb):
    rng = np.random.default_rng(S * 100 + ga + gb)
    a = rng.integers(0, 500, size=(S, ga)).astype(np.int32)
    b = rng.integers(0, 500, size=(S, gb)).astype(np.int32)
    a[rng.random((S, ga)) < 0.25] = -1
    b[rng.random((S, gb)) < 0.25] = -1
    check_match(a, b)


@pytest.mark.parametrize("B,S", [(1, 8), (4, 13), (6, 64)])
def test_group_match_batched(B, S):
    rng = np.random.default_rng(B * 31 + S)
    a = rng.integers(0, 300, size=(B, S, 16)).astype(np.int32)
    b = rng.integers(0, 300, size=(B, S, 24)).astype(np.int32)
    a[rng.random(a.shape) < 0.25] = -1
    b[rng.random(b.shape) < 0.25] = -1
    out = check_match(a, b)
    assert out.shape == (B, S, 16)
    for i in range(B):
        np.testing.assert_array_equal(out[i], check_match(a[i], b[i]))


@pytest.mark.parametrize("kind_a,kind_b", [
    ("left", "left"), ("full", "full"), ("pad", "full"), ("full", "pad"),
    ("interior", "interior"), ("left", "interior")])
@pytest.mark.parametrize("ga,gb", [(1, 1), (3, 33), (33, 3), (32, 32)])
def test_group_match_padding_layouts(kind_a, kind_b, ga, gb):
    """The contract the CUDA kernel keeps whatever the rows' layout: -1
    wherever it lies never matches, repeats in B count once, and widths
    need not be multiples of 4."""
    rng = np.random.default_rng(ga * 100 + gb)
    a = padded_rows(rng, kind_a, (19, ga))
    b = padded_rows(rng, kind_b, (19, gb))
    out = check_match(a, b)
    want = np.array([[v != -1 and v in set(b[s]) for v in a[s]]
                     for s in range(len(a))])
    np.testing.assert_array_equal(out, want)


def test_group_match_sentinel_never_matches():
    a = np.full((4, 8), -1, dtype=np.int32)
    b = np.full((4, 8), -1, dtype=np.int32)
    assert not check_match(a, b).any()


def compact_case(kind: str):
    """(rows, take) of one compaction case: int32 rows with -1 where a
    value was dropped, and the rows' take flags."""
    rng = np.random.default_rng(len(kind))
    shape = {"single_row_past_a_tile": (1, 3 * 8192 + 5),
             "one_row": (1, 64, 8)}.get(kind, (6, 50, 8))
    rows = rng.integers(0, 1 << 31, size=shape, dtype=np.int64).astype(np.int32)
    rows[rng.random(shape) < 0.7] = -1
    take = np.ones(shape[0], dtype=bool)
    if kind == "all_dropped":
        rows[:] = -1
    elif kind == "none_dropped":
        rows = np.abs(rows)
    elif kind == "overflow_rows":
        take[[1, 4]] = False
    elif kind == "no_row_taken":
        take[:] = False
    return rows, take


@pytest.mark.parametrize("kind", ["mixed", "all_dropped", "none_dropped",
                                  "one_row", "overflow_rows", "no_row_taken",
                                  "single_row_past_a_tile"])
def test_compact_rows_against_numpy(kind):
    """Each taken row's slice is ``row[row != -1]`` in position order, a
    row not taken gets an empty one, and the offsets are exact."""
    rows, take = compact_case(kind)
    want_vals = [r.ravel()[r.ravel() != -1] if t else np.empty(0, np.int32)
                 for r, t in zip(rows, take)]
    want_off = np.concatenate([[0], np.cumsum([len(v) for v in want_vals])])
    for fn in (ref.compact_rows_ref, ops.compact_rows):
        values, offsets = fn(torch.from_numpy(rows), torch.from_numpy(take))
        assert values.dtype == torch.int32 and offsets.dtype == torch.int64
        np.testing.assert_array_equal(offsets.numpy(), want_off)
        assert values.shape == (want_off[-1],)
        for b, want in enumerate(want_vals):
            np.testing.assert_array_equal(
                values[offsets[b]:offsets[b + 1]].numpy(), want)


def test_cuda_wrappers_refuse_cpu_tensors():
    imgs = torch.zeros((2, 16, 2, 8), dtype=torch.int32)
    rows = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        bitmap_filter_cuda(imgs)
    with pytest.raises(ValueError):
        group_match_cuda(rows, rows)
    with pytest.raises(ValueError):
        compact_rows_cuda(rows, torch.ones(4, dtype=torch.bool))


def test_router_sends_cpu_tensors_to_plain_versions():
    before = (bitmap_filter_cuda.launches, group_match_cuda.launches,
              compact_rows_cuda.launches)
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 1 << 32, size=(2, 200, 2, 8),
                        dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(ops.bitmap_filter(as_torch(imgs)).numpy(),
                                  ref.bitmap_filter_ref(as_torch(imgs)).numpy())
    a = torch.from_numpy(rng.integers(0, 99, size=(16, 16)).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 99, size=(16, 24)).astype(np.int32))
    np.testing.assert_array_equal(ops.group_match(a, b).numpy(),
                                  ref.group_match_ref(a, b).numpy())
    rows = torch.where(a > 50, a, -1)
    take = torch.arange(16) % 3 > 0
    for got, want in zip(ops.compact_rows(rows, take),
                         ref.compact_rows_ref(rows, take)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (bitmap_filter_cuda.launches, group_match_cuda.launches,
            compact_rows_cuda.launches) == before
    with pytest.raises(ValueError):
        ops.bitmap_filter(as_torch(imgs).to("meta"))


def test_build_sources_and_digest(tmp_path, monkeypatch):
    """The library is keyed by a hash of its sources and flags: a changed
    source gets a new library name, an unchanged one the same."""
    names = [p.name for p in _build.sources()]
    assert {"bitmap_filter.cu", "compact_rows.cu", "group_match.cu",
            "pair_count.cu"} <= set(names)
    for src in _build.sources():
        text = src.read_text()
        assert 'extern "C"' in text
    before = _build._digest()
    assert before == _build._digest()
    for src in _build.sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._digest() == before
    (tmp_path / "group_match.cu").write_text("// changed\n")
    assert _build._digest() != before
