"""Runnable examples of the port (``examples/`` of the repo holds the JAX
package's): ``python -m raytracing_tpu_torch.examples.<name> [--cpu]``
with ``smoke_render``, ``inverse_render`` and ``silhouette_optim``. Each
runs on the card unless ``--cpu`` is given."""
