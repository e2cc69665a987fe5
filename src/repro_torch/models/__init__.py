"""LM models of the port: the dense family (``transformer``), the MoE
(``moe``), Mamba2-hybrid (``ssm``), xLSTM (``xlstm``) and
encoder-decoder (``encdec``) families behind the ``model.build_model``
facade, their building blocks (``layers``) and the parameter carrier from
the JAX package's tree (``convert``)."""
