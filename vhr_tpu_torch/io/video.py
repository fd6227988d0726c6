"""Host-side video decode and encode (OpenCV), and a read-ahead chunk reader.

The port's own copy of ``vhr_tpu/io/video.py``'s reader and writer
(``read_video``, ``iter_video_chunks``, ``video_metadata``, ``write_video``,
``HAVE_CV2``) and its truth-CSV helpers (``read_truth_csv``, read with the
``csv`` module instead of pandas, and ``align_truth_to_measurement``).
Decode cannot run on the card, so this layer delivers contiguous
``(T, H, W, 3)`` uint8 BGR frames, whole or in chunks.

:class:`ChunkReader` stands in for the JAX package's native framestore
(``vhr_tpu/io/native``), which needs OpenCV's C++ headers: cv2 decode
ahead on background threads (cv2 releases the GIL while it decodes), one
decoder or several over disjoint segments (``n_decoders``), BGR or planar
I420 staging (``fmt``), into a pool of pinned host buffers copied to the
card with ``non_blocking=True`` on a side stream.
"""

from __future__ import annotations

import csv
import math
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
           "video_metadata", "read_truth_csv", "align_truth_to_measurement",
           "ChunkReader"]


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


# The cells pandas' ``read_csv`` reads as missing (its default ``na_values``).
_NA = frozenset(["", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"])


def _cell(text: str) -> float:
    text = text.strip()
    return math.nan if text in _NA else float(text)


def read_truth_csv(path: str) -> np.ndarray:
    """Load a ground-truth CSV with columns (timestamp, heart_rate).

    Cleaning contract of ``video_io.read_truth_for_video``, as the JAX
    package applies it with pandas: keep the two columns (in any order,
    other columns ignored), drop rows with a missing cell in either,
    de-duplicate timestamps (the first row in file order wins), sort by
    time.  Returns ``(N, 2)`` float64.
    """
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    header = rows[0] if rows else []
    if not {"timestamp", "heart_rate"}.issubset(header):
        raise ValueError(
            "ground truth must have columns ['timestamp', 'heart_rate']")
    cols = header.index("timestamp"), header.index("heart_rate")
    data = np.array([[_cell(r[c]) if c < len(r) else math.nan for c in cols]
                     for r in rows[1:]], np.float64).reshape(-1, 2)
    data = data[~np.isnan(data).any(1)]
    # np.unique sorts the timestamps and points at each one's first row.
    _, first = np.unique(data[:, 0], return_index=True)
    if first.size == 0:
        raise ValueError("ground truth has no valid rows")
    return data[first]


def align_truth_to_measurement(truth: np.ndarray, measured: np.ndarray
                               ) -> np.ndarray:
    """Zero-order-hold alignment of truth HR to measurement timestamps.

    Semantics of ``video_io.interpolate_hr_to_frames``: for each measured
    timestamp, take the last truth sample at or before it (clamped to the
    first sample).  Returns ``(N, 2)`` ``[t, hr]``.
    """
    truth = np.asarray(truth, dtype=float)
    measured = np.asarray(measured)
    if measured.ndim != 2 or measured.shape[1] < 1:
        raise ValueError("measured must be 2D with timestamps in column 0")
    t_meas = measured[:, 0].astype(float)
    idx = np.searchsorted(truth[:, 0], t_meas, side="right") - 1
    idx = np.clip(idx, 0, len(truth) - 1)
    return np.column_stack([t_meas, truth[idx, 1]])


class ChunkReader:
    """Read-ahead chunked decode, staged for ``device``.

    >>> with ChunkReader("clip.avi", 256, "cuda", n_decoders=4) as reader:
    ...     for frames, start in reader:     # (n, H, W, 3) u8 on the card
    ...         ...

    Yields the chunks of :func:`iter_video_chunks` (the last one may be
    shorter) as tensors on ``device``, with their first frame's index, while
    background threads decode ahead.

    * ``n_decoders > 1`` decodes disjoint, contiguous runs of chunk-aligned
      segments in parallel, each worker with its own ``cv2.VideoCapture``
      seeked to its first frame (``CAP_PROP_POS_FRAMES``; the seek is
      exact on MJPG and ``mp4v``, which the tests hold), at most 8
      workers and no more than there are chunks; chunks come out in order,
      equal to one decoder's.  A file that reports no frame count gets one
      worker.  cv2's ``read`` and ``cvtColor`` release the GIL, so the
      threads decode in parallel.
    * ``fmt="i420"`` converts each frame on its decode thread with
      ``cv2.COLOR_BGR2YUV_I420`` and yields ``(n, H*3//2, W)`` planar
      chunks (1.5 bytes a pixel); odd ``H`` or ``W`` raise ``IOError``.

    The workers share one pool of ``n_workers + 1`` chunk buffers, pinned on
    a CUDA device.  A worker takes a buffer for chunk ``c`` only once ``c``
    is at most ``n_workers`` past the next chunk to be yielded: the other
    chunks of that window can hold ``n_workers`` buffers, which leaves one
    for the next chunk.  On a CUDA
    device a chunk's copy is enqueued on a side stream and the current
    stream waits for it, so the copy of chunk k+1 overlaps the work on chunk
    k; an event recorded after each copy is waited on before its buffer is
    filled again.  Leaving the ``with`` block (or :meth:`close`) stops the
    threads and releases the captures, also after an early exit or an
    exception.
    """

    def __init__(self, path: str, chunk_frames: int, device,
                 n_decoders: int = 1, fmt: str = "bgr"):
        if chunk_frames < 1:
            raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
        if fmt not in ("bgr", "i420"):
            raise ValueError(f"fmt must be 'bgr' or 'i420', got {fmt!r}")
        self.path, self.fmt, self.chunk_frames = path, fmt, chunk_frames
        cap = _open(path)
        self.fps = float(cap.get(cv2.CAP_PROP_FPS))
        self.width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.frame_count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if fmt == "i420" and (self.width % 2 or self.height % 2):
            cap.release()
            raise IOError(f"I420 needs even frame sides, {path} is "
                          f"{self.width}x{self.height}")
        n_chunks = -(-self.frame_count // chunk_frames)
        n = min(max(int(n_decoders), 1), 8)
        self.n_workers = min(n, n_chunks) if self.frame_count > 0 else 1
        per = -(-n_chunks // self.n_workers) if self.frame_count > 0 else 0
        # Worker w owns chunks [w * per, (w + 1) * per); the last one reads
        # on to the end of the file whatever the reported count.
        self._segments = [(w * per, (w + 1) * per
                           if w < self.n_workers - 1 else None)
                          for w in range(self.n_workers)]
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self._pin = cuda
        n_bufs = self.n_workers + 1
        self._bufs: List[Optional[torch.Tensor]] = [None] * n_bufs
        self._events = ([torch.cuda.Event() for _ in range(n_bufs)]
                        if cuda else None)
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._free: queue.Queue = queue.Queue()
        for i in range(n_bufs):
            self._free.put(i)
        self._cond = threading.Condition()
        self._next = 0               # the next chunk index to yield
        self._ready: dict = {}       # chunk index -> (buffer, frames)
        self._end: Optional[int] = None   # the first chunk past the file
        self._error: Optional[BaseException] = None
        self._done = 0               # workers finished
        self._stop = threading.Event()
        self._threads = []
        for w in range(self.n_workers):
            th = threading.Thread(target=self._worker,
                                  args=(w, cap if w == 0 else None),
                                  name=f"ChunkReader-{w}", daemon=True)
            self._threads.append(th)
        for th in self._threads:
            th.start()

    @property
    def frame_shape(self) -> Tuple[int, ...]:
        """One staged frame's shape: ``(H, W, 3)``, or ``(H*3//2, W)``."""
        if self.fmt == "i420":
            return (self.height * 3 // 2, self.width)
        return (self.height, self.width, 3)

    @property
    def pinned_bytes(self) -> int:
        """Bytes of pinned host memory the buffer pool holds."""
        return sum(b.numel() for b in self._bufs if b is not None) \
            if self._pin else 0

    # -- decode threads -----------------------------------------------------
    def _buffer(self, i: int) -> torch.Tensor:
        if self._bufs[i] is None:
            self._bufs[i] = torch.empty(
                (self.chunk_frames,) + self.frame_shape, dtype=torch.uint8,
                pin_memory=self._pin)
        return self._bufs[i]

    def _fill(self, cap, buf: torch.Tensor, scratch: list) -> int:
        """Decode up to ``chunk_frames`` frames of ``cap`` into ``buf``."""
        n = 0
        while n < self.chunk_frames and not self._stop.is_set():
            row = buf[n].numpy()
            if self.fmt == "i420":
                ok, frame = cap.read(scratch[0])
                if ok:
                    scratch[0] = frame
                    if frame.shape[:2] != (self.height, self.width):
                        raise IOError(f"frame of {frame.shape} in a "
                                      f"{self.width}x{self.height} video")
                    out = cv2.cvtColor(frame, cv2.COLOR_BGR2YUV_I420,
                                       dst=row)
                    if not np.may_share_memory(out, row):
                        row[...] = out
            else:
                ok, frame = cap.read(row)
                if ok and not np.may_share_memory(frame, row):
                    if frame.shape != row.shape:
                        raise IOError(f"frame of {frame.shape} in a "
                                      f"{self.width}x{self.height} video")
                    row[...] = frame
            if not ok:
                break
            n += 1
        return n

    def _take_buffer(self, c: int) -> Optional[int]:
        """A free buffer for chunk ``c``, once ``c`` is within the window;
        ``None`` when the reader stops first."""
        with self._cond:
            self._cond.wait_for(lambda: self._stop.is_set()
                                or c <= self._next + self.n_workers)
        while not self._stop.is_set():
            try:
                i = self._free.get(timeout=0.05)
            except queue.Empty:
                continue
            if self._events is not None:
                # The buffer's previous copy to the card must be done.
                self._events[i].synchronize()
            return i
        return None

    def _worker(self, w: int, cap) -> None:
        c0, c1 = self._segments[w]
        try:
            if cap is None:
                cap = _open(self.path)
            if c0 > 0:
                cap.set(cv2.CAP_PROP_POS_FRAMES, c0 * self.chunk_frames)
            scratch = [None]
            c = c0
            while c1 is None or c < c1:
                i = self._take_buffer(c)
                if i is None:
                    return
                n = self._fill(cap, self._buffer(i), scratch)
                with self._cond:
                    if n:
                        self._ready[c] = (i, n)
                    else:
                        self._free.put(i)
                    if n < self.chunk_frames:
                        end = c + 1 if n else c
                        self._end = end if self._end is None \
                            else min(self._end, end)
                    self._cond.notify_all()
                if n < self.chunk_frames or self._stop.is_set():
                    return
                c += 1
        except BaseException as e:   # handed to the consumer, raised there
            with self._cond:
                if self._error is None:
                    self._error = e
        finally:
            if cap is not None:
                cap.release()
            with self._cond:
                self._done += 1
                self._cond.notify_all()

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

    def _next_ready(self):
        """``(buffer, frames)`` of the next chunk, or ``None`` at the end."""
        with self._cond:
            while True:
                if self._error is not None:
                    raise self._error
                if self._next in self._ready:
                    return self._ready.pop(self._next)
                if ((self._end is not None and self._next >= self._end)
                        or self._done == self.n_workers):
                    return None
                self._cond.wait()

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, int]]:
        while True:
            item = self._next_ready()
            if item is None:
                return
            i, n = item
            start = self._next * self.chunk_frames
            chunk = self._stage(i, n)
            self._free.put(i)
            with self._cond:
                self._next += 1
                self._cond.notify_all()
            yield chunk, start

    def close(self) -> None:
        """Stop the decode threads and release the captures."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for th in self._threads:
            th.join()

    def __enter__(self) -> "ChunkReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
