"""tensoir_tpu_torch: TensoIR in PyTorch, with hand-written CUDA kernels for
the NVIDIA H100 (sm_90a).

A port of the JAX package ``tensoir_tpu``, which stays the reference: the
same functions under the same relative paths, parameters in dicts keyed
like its pytrees. The port imports nothing of JAX or of ``tensoir_tpu``,
nor PIL, imageio or cv2.

It covers the training run of the shipped configs (the radiance and
relight steps, the alpha-mask / shrink / upsample schedule, checkpoints),
the evaluation, the dataset loaders, the training CLI
(``python -m tensoir_tpu_torch.train_tensoir``) and the synthetic demo
(``tensoir_tpu_torch.examples``). Its VM plane lookups run on two kernels
written for the card, ``kernels.row_gather`` (K1) and
``kernels.row_scatter_add`` (K2), in ``csrc/``. Entry points run on the
card (``device=None`` means CUDA) unless the caller passes ``"cpu"``; on
the CPU the kernels' plain PyTorch versions run instead.
"""
from tensoir_tpu_torch.device import resolve_device  # noqa: F401
