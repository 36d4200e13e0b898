"""Webcam streaming (counterpart of ``super_gradients_tpu/inference/stream.py``).

``WebcamStreaming`` reads frames from a cv2 capture device, runs
``frame_processing_fn`` on each (typically one image's predict and draw), writes the
measured FPS on it and shows it until ``q`` is pressed. cv2 is imported at the call;
a capture device that does not open raises ``ValueError``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np


class FPSCounter:
    """Frames a second over windows of ``update_frequency`` seconds (every frame if None)."""

    def __init__(self, update_frequency: Optional[float] = None):
        self._update_frequency = update_frequency
        self._start_time = time.time()
        self._frame_count = 0
        self._fps = 0.0

    def tick(self) -> float:
        self._frame_count += 1
        elapsed = time.time() - self._start_time
        if self._update_frequency is None or elapsed >= self._update_frequency:
            if elapsed > 0:
                self._fps = self._frame_count / elapsed
            self._start_time = time.time()
            self._frame_count = 0
        return self._fps

    @property
    def fps(self) -> float:
        return self._fps


def write_fps_to_frame(frame: np.ndarray, fps: float) -> np.ndarray:
    import cv2

    cv2.putText(frame, f"FPS: {fps:.1f}", (10, 30), cv2.FONT_HERSHEY_SIMPLEX, 1.0, (0, 255, 0), 2)
    return frame


class WebcamStreaming:
    def __init__(self, window_name: str = "", frame_processing_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 capture: int = 0, fps_update_frequency: Optional[float] = None):
        self.window_name = window_name
        self.frame_processing_fn = frame_processing_fn
        self._capture_id = capture
        self._cap = None
        self._fps_counter = FPSCounter(update_frequency=fps_update_frequency)

    @property
    def fps(self) -> float:
        return self._fps_counter.fps

    def run(self) -> None:
        import cv2

        self._cap = cv2.VideoCapture(self._capture_id)
        try:
            if not self._cap.isOpened():
                raise ValueError(f"cannot open capture device {self._capture_id}")
            while self._display_single_frame():
                pass
        finally:
            self._stop()

    def _display_single_frame(self) -> bool:
        import cv2

        ok, frame = self._cap.read()
        if not ok:
            return False
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if self.frame_processing_fn is not None:
            frame = self.frame_processing_fn(frame)
        frame = np.ascontiguousarray(frame, np.uint8)
        write_fps_to_frame(frame, self._fps_counter.tick())
        cv2.imshow(self.window_name, cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        return (cv2.waitKey(1) & 0xFF) != ord("q")

    def _stop(self) -> None:
        import cv2

        if self._cap is not None:
            self._cap.release()
            self._cap = None
        try:
            cv2.destroyAllWindows()
        except cv2.error:
            pass  # no display: there is no window to close
