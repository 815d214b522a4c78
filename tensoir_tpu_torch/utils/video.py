"""Video export (the port's counterpart of tensoir_tpu.utils.video).

The JAX package writes mp4s (or GIFs) of the frames it rendered through
imageio. The port uses no video encoder: it writes a video's frames as
PNGs into a folder named after the video, or, where its caller wrote the
frames already (the eval's per-view panels, the path's frames), only says
that no video file was made from them.
"""
from __future__ import annotations

import os
from typing import Sequence, Tuple, Union

import numpy as np

from tensoir_tpu_torch.utils.png import write_png


def write_videos(out_dir: str,
                 videos: Sequence[Tuple[str, Union[int, Sequence]]],
                 tag: str = "video") -> None:
    """Each video (name, frames): a list of uint8 [H, W(, C)] frames is
    written as ``<out_dir>/<name>/<i:03d>.png``; a frame count stands for
    frames written elsewhere. One note names the videos that a video
    encoder would have written to ``out_dir``."""
    videos = [(n, f) for n, f in videos if (f if isinstance(f, int)
                                            else len(f))]
    if not videos:
        return
    for name, frames in videos:
        if isinstance(frames, int):
            continue
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        for i, frame in enumerate(frames):
            write_png(os.path.join(d, f"{i:03d}.png"), np.asarray(frame))
    counts = [(n, f if isinstance(f, int) else len(f)) for n, f in videos]
    print(f"[{tag}] no video encoder (imageio/ffmpeg) in the port: "
          f"{', '.join(f'{n} ({k} frames)' for n, k in counts)} not "
          f"written as videos to {out_dir}; the frames are PNGs", flush=True)
