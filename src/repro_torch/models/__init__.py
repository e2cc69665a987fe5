"""LM models of the port: the dense family (``transformer``) behind the
``model.build_model`` facade, its building blocks (``layers``) and the
parameter carrier from the JAX package's tree (``convert``)."""
