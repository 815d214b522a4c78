"""tensoir_tpu_torch: TensoIR in PyTorch, with hand-written CUDA kernels for
the NVIDIA H100 (sm_90a).

A port of the JAX package ``tensoir_tpu``, which stays the reference: the
same functions under the same relative paths, parameters in dicts keyed
like its pytrees. The port imports nothing of JAX or of ``tensoir_tpu``.

So far it covers the radiance-phase training step (dense march, VM field,
MLP_Fea shading, losses, per-group Adam). Its VM plane lookups run on two
kernels written for the card, ``kernels.row_gather`` (K1) and
``kernels.row_scatter_add`` (K2), in ``csrc/``. Entry points run on the
card (``device=None`` means CUDA) unless the caller passes ``"cpu"``; on
the CPU the kernels' plain PyTorch versions run instead.
"""
from tensoir_tpu_torch.device import resolve_device  # noqa: F401
