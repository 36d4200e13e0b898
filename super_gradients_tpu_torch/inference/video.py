"""Video files (counterpart of ``super_gradients_tpu/inference/video.py``).

cv2 reads and writes MP4 / AVI, PIL writes GIF; both are imported at the call. Frames
are RGB uint8 HWC throughout (cv2's BGR is converted at the boundary).
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".gif")


def includes_video_extension(file_path) -> bool:
    return isinstance(file_path, str) and file_path.lower().endswith(VIDEO_EXTENSIONS)


def check_is_gif(file_path) -> bool:
    return isinstance(file_path, str) and file_path.lower().endswith(".gif")


def _open_video(file_path: str):
    """A cv2 capture of the file; raises ``ValueError`` when cv2 cannot open it."""
    import cv2

    cap = cv2.VideoCapture(file_path)
    if not cap.isOpened():
        raise ValueError(f"cannot open video file: {file_path}")
    return cap


def load_video(file_path: str, max_frames: Optional[int] = None) -> Tuple[List[np.ndarray], int]:
    """All frames (RGB uint8) and the rounded frame rate."""
    frames, fps, _ = lazy_load_video(file_path, max_frames)
    return list(frames), fps


def lazy_load_video(file_path: str, max_frames: Optional[int] = None) -> Tuple[Iterator[np.ndarray], int, int]:
    """A frame iterator, the rounded frame rate and the frame count of the file's header
    (cut to ``max_frames``), without reading the frames up front."""
    import cv2

    cap = _open_video(file_path)
    fps = int(round(cap.get(cv2.CAP_PROP_FPS) or 25))
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if max_frames is not None:
        total = min(total, max_frames)

    def gen():
        n = 0
        try:
            while max_frames is None or n < max_frames:
                ok, frame = cap.read()
                if not ok:
                    break
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                n += 1
        finally:
            cap.release()

    return gen(), fps, total


def save_video(output_path: str, frames: Iterable[np.ndarray], fps: int) -> None:
    """GIF or MP4 / AVI by the path's extension."""
    if not includes_video_extension(output_path):
        raise ValueError(f"output_path must end with one of {VIDEO_EXTENSIONS}, got {output_path}")
    if check_is_gif(output_path):
        save_gif(output_path, frames, fps)
    else:
        save_mp4(output_path, frames, fps)


def save_gif(output_path: str, frames: Iterable[np.ndarray], fps: int) -> None:
    from PIL import Image

    pil = [Image.fromarray(np.asarray(f, np.uint8)) for f in frames]
    if not pil:
        raise ValueError("no frames to save")
    pil[0].save(output_path, save_all=True, append_images=pil[1:], duration=int(1000 / max(fps, 1)), loop=0)


def save_mp4(output_path: str, frames: Iterable[np.ndarray], fps: int) -> None:
    """cv2 ``VideoWriter`` (``mp4v`` for .mp4, else ``XVID``); every frame the first's size."""
    import cv2

    writer = None
    shape = None
    try:
        for frame in frames:
            frame = np.asarray(frame, np.uint8)
            if writer is None:
                shape = frame.shape[:2]
                fourcc = cv2.VideoWriter_fourcc(*("mp4v" if output_path.lower().endswith(".mp4") else "XVID"))
                writer = cv2.VideoWriter(output_path, fourcc, float(fps), (shape[1], shape[0]))
            if frame.shape[:2] != shape:
                raise RuntimeError(f"frame size {frame.shape[:2]} != first frame {shape}; all frames must match")
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    finally:
        if writer is not None:
            writer.release()
    if writer is None:
        raise ValueError("no frames to save")
    if not os.path.exists(output_path):
        raise RuntimeError(f"cv2 failed to write {output_path}")
