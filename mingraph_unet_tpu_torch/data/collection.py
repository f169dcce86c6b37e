"""Data collection tools: webcam capture and video → frame extraction.
The port's own copy of ``mingraph_unet_tpu/data/collection.py``: host
OpenCV, imported on use; no device work.
"""

from __future__ import annotations

import os
import time
from typing import Optional

__all__ = ["VideoCapture", "FrameExtractor"]


class VideoCapture:
    """Webcam → timestamped mp4: fps falls back to 30 when the camera
    reports none; optional live preview, 'q' stops it."""

    def __init__(self, camera_index: int = 0, output_dir: str = "captured_videos"):
        self.camera_index = camera_index
        self.output_dir = output_dir

    def capture_video(self, duration_sec: float = 10.0, show_preview: bool = False) -> str:
        import cv2

        os.makedirs(self.output_dir, exist_ok=True)
        cap = cv2.VideoCapture(self.camera_index)
        if not cap.isOpened():
            raise RuntimeError(f"Cannot open camera index {self.camera_index}")
        fps = cap.get(cv2.CAP_PROP_FPS)
        if not fps or fps <= 0:
            fps = 30.0
        width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        out_path = os.path.join(self.output_dir, f"capture_{int(time.time())}.mp4")
        writer = cv2.VideoWriter(
            out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height)
        )
        t_end = time.time() + duration_sec
        try:
            while time.time() < t_end:
                ok, frame = cap.read()
                if not ok:
                    break
                writer.write(frame)
                if show_preview:
                    cv2.imshow("capture", frame)
                    if cv2.waitKey(1) & 0xFF == ord("q"):
                        break
        finally:
            cap.release()
            writer.release()
            if show_preview:
                cv2.destroyAllWindows()
        return out_path


class FrameExtractor:
    """Video → every Nth frame as png/jpg into a per-video subdir."""

    def __init__(self, frame_interval: int = 30, image_format: str = "png"):
        if image_format not in ("png", "jpg"):
            raise ValueError("image_format must be 'png' or 'jpg'")
        self.frame_interval = max(1, int(frame_interval))
        self.image_format = image_format

    def extract_frames(self, video_path: str, output_dir: str) -> int:
        import cv2

        if not os.path.isfile(video_path):
            raise FileNotFoundError(video_path)
        stem = os.path.splitext(os.path.basename(video_path))[0]
        frame_dir = os.path.join(output_dir, stem)
        os.makedirs(frame_dir, exist_ok=True)
        cap = cv2.VideoCapture(video_path)
        if not cap.isOpened():
            raise RuntimeError(f"Cannot open video {video_path!r}")
        saved = 0
        idx = 0
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                if idx % self.frame_interval == 0:
                    name = f"{stem}_frame{idx:06d}.{self.image_format}"
                    cv2.imwrite(os.path.join(frame_dir, name), frame)
                    saved += 1
                idx += 1
        finally:
            cap.release()
        return saved
