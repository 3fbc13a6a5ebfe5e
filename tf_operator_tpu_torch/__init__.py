"""PyTorch/CUDA port of the tf_operator_tpu data plane, for NVIDIA Hopper.

The JAX package (``tf_operator_tpu``) is the reference; this package
mirrors its module paths and names so each port module sits at the path
of its counterpart. It imports ``torch`` and never ``jax`` or anything
of ``tf_operator_tpu``: it keeps its own copies of what it needs.

Ported so far: the paged-KV serving path (``serve/``,
``workloads/serve.py``) with its one kernel, paged decode attention
(``ops/csrc/paged_decode.cu``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (see ``device.resolve_device``).
"""
