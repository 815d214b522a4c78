"""Video export (the port's counterpart of tensoir_tpu.utils.video).

The JAX package writes mp4s (or GIFs) of the frames it rendered through
imageio. The port uses no video encoder: its callers write every frame as
a PNG anyway (the eval's per-view panels, the path's frames), and
``write_videos`` only says that no video file was made from them.
"""
from __future__ import annotations

from typing import Sequence, Tuple


def write_videos(out_dir: str, videos: Sequence[Tuple[str, int]],
                 tag: str = "video") -> None:
    """One note naming the videos, (name, frame count), that a video
    encoder would have written to ``out_dir``."""
    videos = [(n, k) for n, k in videos if k]
    if videos:
        print(f"[{tag}] no video encoder (imageio/ffmpeg) in the port: "
              f"{', '.join(f'{n} ({k} frames)' for n, k in videos)} not "
              f"written to {out_dir}; the frames are the PNGs written beside "
              f"it", flush=True)
