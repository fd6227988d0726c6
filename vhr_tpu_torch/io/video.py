"""Host-side video decode and encode (OpenCV), and a read-ahead chunk reader.

The port's own copy of ``vhr_tpu/io/video.py``'s reader and writer
(``read_video``, ``iter_video_chunks``, ``video_metadata``, ``write_video``,
``HAVE_CV2``); the truth-CSV helpers stay in the JAX package.  Decode cannot
run on the card, so this layer delivers contiguous ``(T, H, W, 3)`` uint8
BGR frames, whole or in chunks.

:class:`ChunkReader` stands in for the JAX package's native framestore
(``vhr_tpu/io/native``), which needs OpenCV's C++ headers: it runs
:func:`iter_video_chunks`'s decode one chunk ahead on a background thread
(cv2 releases the GIL while it decodes), the overlap ``NativeVideoReader``
gives with one decoder.  On a CUDA device each chunk is decoded into one of
two pinned host buffers and copied to the card with ``non_blocking=True``
on a side stream; an event recorded after each copy is waited on before
that buffer is filled again.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

try:
    import cv2
    HAVE_CV2 = True
except ImportError:  # pragma: no cover - environment without OpenCV
    cv2 = None
    HAVE_CV2 = False

__all__ = ["HAVE_CV2", "read_video", "iter_video_chunks", "write_video",
           "video_metadata", "ChunkReader"]


def _require_cv2():
    if not HAVE_CV2:
        raise RuntimeError("OpenCV (cv2) is required for video I/O but is "
                           "not available in this environment")


def _open(path: str):
    _require_cv2()
    if not os.path.exists(path):
        raise FileNotFoundError(f"video not found: {path}")
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"failed to open video: {path}")
    return cap


def video_metadata(path: str) -> Tuple[int, int, float, int, float]:
    """(width, height, fps, frame_count, bitrate_bps) of a video file."""
    _require_cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"failed to open video: {path}")
    meta = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            float(cap.get(cv2.CAP_PROP_FPS)),
            int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            float(cap.get(cv2.CAP_PROP_BITRATE)) * 1000.0)
    cap.release()
    return meta


def read_video(path: str, max_frames: Optional[int] = None
               ) -> Tuple[np.ndarray, float]:
    """Decode a whole video into one contiguous ``(T, H, W, 3)`` uint8
    array (one host buffer, one device transfer)."""
    cap = _open(path)
    fps = float(cap.get(cv2.CAP_PROP_FPS))
    frames: List[np.ndarray] = []
    while max_frames is None or len(frames) < max_frames:
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(frame)
    cap.release()
    if not frames:
        return np.zeros((0, 0, 0, 3), np.uint8), fps
    return np.ascontiguousarray(np.stack(frames)), fps


def iter_video_chunks(path: str, chunk_frames: int
                      ) -> Iterator[Tuple[np.ndarray, float, int]]:
    """Stream ``(frames, fps, start_index)`` chunks without whole-video RAM."""
    _require_cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"failed to open video: {path}")
    fps = float(cap.get(cv2.CAP_PROP_FPS))
    start = 0
    buf: List[np.ndarray] = []
    while True:
        ret, frame = cap.read()
        if ret:
            buf.append(frame)
        if buf and (len(buf) == chunk_frames or not ret):
            yield np.ascontiguousarray(np.stack(buf)), fps, start
            start += len(buf)
            buf = []
        if not ret:
            break
    cap.release()


def write_video(frames: np.ndarray, path: str, fps: float,
                fourcc: str = "mp4v") -> None:
    """Write ``(T, H, W, 3)`` uint8 BGR frames with the given four-character
    codec (``"mp4v"`` for ``.mp4``, ``"MJPG"`` for ``.avi``)."""
    _require_cv2()
    frames = np.asarray(frames)
    if frames.size == 0:
        raise ValueError("no frames to write")
    h, w = frames.shape[1:3]
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    if not out.isOpened():
        raise IOError(f"failed to open a {fourcc} writer for {path}")
    try:
        for f in frames:
            out.write(np.ascontiguousarray(f))
    finally:
        out.release()


class ChunkReader:
    """Read-ahead chunked decode, staged for ``device``.

    >>> with ChunkReader("clip.avi", 256, "cuda") as reader:
    ...     for frames, start in reader:     # (n, H, W, 3) u8 on the card
    ...         ...

    Yields the chunks of :func:`iter_video_chunks` (the last one may be
    shorter) as tensors on ``device``, with their first frame's index.  A
    background thread decodes the next chunk while the caller works on the
    current one.  On a CUDA device a chunk's copy is enqueued on a side
    stream and the current stream waits for it, so the copy of chunk k+1
    overlaps the work on chunk k.  Leaving the ``with`` block (or
    :meth:`close`) stops the thread and releases the capture, also after an
    early exit or an exception.
    """

    def __init__(self, path: str, chunk_frames: int, device):
        if chunk_frames < 1:
            raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
        self._cap = _open(path)
        self.fps = float(self._cap.get(cv2.CAP_PROP_FPS))
        self.chunk_frames = chunk_frames
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self._bufs: List[Optional[torch.Tensor]] = [None, None]
        self._pin = cuda
        self._events = [torch.cuda.Event() for _ in range(2)] if cuda else None
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._free = [threading.Semaphore(1), threading.Semaphore(1)]
        self._ready: queue.Queue = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._decode,
                                        name="ChunkReader", daemon=True)
        self._thread.start()

    # -- decode thread ------------------------------------------------------
    def _fill(self, i: int) -> int:
        """Decode up to ``chunk_frames`` frames into buffer ``i``."""
        n = 0
        while n < self.chunk_frames and not self._stop.is_set():
            buf = self._bufs[i]
            view = None if buf is None else buf[n].numpy()
            ok, frame = self._cap.read(view)
            if not ok:
                break
            if buf is None:
                buf = torch.empty((self.chunk_frames,) + frame.shape,
                                  dtype=torch.uint8, pin_memory=self._pin)
                self._bufs[i] = buf
                view = None
            if view is None or not np.may_share_memory(frame, view):
                buf[n].numpy()[...] = frame
            n += 1
        return n

    def _decode(self) -> None:
        try:
            k = start = 0
            while True:
                i = k % 2
                self._free[i].acquire()
                if self._stop.is_set():
                    return
                if self._events is not None:
                    # The buffer's previous copy to the card must be done.
                    self._events[i].synchronize()
                n = self._fill(i)
                if n == 0 or self._stop.is_set():
                    return
                self._ready.put((i, n, start))
                start += n
                k += 1
                if n < self.chunk_frames:
                    return
        except BaseException as e:   # handed to the consumer, raised there
            self._ready.put(e)
        finally:
            self._cap.release()
            self._ready.put(None)

    # -- consumer -----------------------------------------------------------
    def _stage(self, i: int, n: int) -> torch.Tensor:
        src = self._bufs[i][:n]
        if self._stream is None:
            return src.clone()
        main = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            out = src.to(self.device, non_blocking=True)
            self._events[i].record(self._stream)
        main.wait_event(self._events[i])
        out.record_stream(main)
        return out

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, int]]:
        while True:
            item = self._ready.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            i, n, start = item
            chunk = self._stage(i, n)
            self._free[i].release()
            yield chunk, start

    def close(self) -> None:
        """Stop the decode thread and release the capture."""
        self._stop.set()
        for s in self._free:
            s.release()
        while self._thread.is_alive():
            try:
                self._ready.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread.join()

    def __enter__(self) -> "ChunkReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
