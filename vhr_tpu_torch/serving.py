"""Serving: an S-slot live BPM pool and its TCP / WebSocket front-end.

Port of ``vhr_tpu/serving.py``: ``init_state_batched``,
``_finish_batched`` (shared with the live step,
``pipeline.live._finish_batched``), ``_step_batched_impl``, ``BpmServer``,
and the front-end (:func:`serve_forever`, :class:`BpmClient`,
:class:`WsBpmClient`), whose wire protocol is the JAX package's byte for
byte: a client cannot tell which package serves it.

The pool keeps every slot's :class:`~vhr_tpu_torch.pipeline.live.LiveState`
on the device as one NamedTuple of tensors with a leading ``(S,)`` slot axis
and advances all slots per tick:

- **One upload, one fetch.**  A tick stacks the frames of the slots that
  sent one into an ``(S, H, W, 3)`` batch in pinned host memory and copies
  it to the card once (``non_blocking``); :meth:`BpmServer.fetch` makes the
  tick's only device-to-host copy, of the packed ``(S, 10)`` outputs.
  Frames already on the card (CUDA ``uint8`` tensors) are copied there.
- **Slots are masks.**  Attach, detach and a missed frame are an ``active``
  mask and a ``reset`` mask over the fixed ``(S, ...)`` state.
- **Fused or skin-detector tick.**  ``use_fused`` runs kernel K4 over the
  batch (each slot's cadence on its own frame counter, read on the card);
  otherwise the skin detector runs over the batch on the pool's tick cadence
  (skipped on the host when the tick is off it) and kernel K2 takes the ROI
  means.
- **Every live method.**  ``cfg.method`` is ``"green"``, a chrominance
  projection (``"chrom"``, ``"pos"``, ``"omit"``) or ``"adaptive"``; the
  projections run over all ``(S, N, 3)`` BGR rings of the pool at once, and
  under ``"adaptive"`` each served line names the method behind its BPM.

- **K subjects a slot.**  ``k_faces > 1`` runs the multi-face update
  (``pipeline.live._multi_update``, the live ``step_multi`` over the slot
  axis): the top-K skin detector over the batch on the pool's tick cadence,
  the K-track holdover, the K ROIs' means in one read of each frame; every
  output field gains a ``(K,)`` axis, and the front-end's JSON lines carry
  one entry per subject.

- **BGR or I420 on the wire.**  With ``transfer="i420"`` frames are ``(H*3//2,
  W)`` planar YUV 4:2:0 (``pipeline.live.bgr_to_i420_host``), half the
  bytes of BGR in the pinned upload; the tick rebuilds BGR on the card
  (``ops.color.i420_to_bgr_flat``) before the same update.

Not ported yet: ``mesh=`` (ROADMAP queue 1, item 14), which raises
``NotImplementedError``.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import hmac
import json
import os
import queue
import socket
import socketserver
import struct
import sys
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import interop
from .device import resolve_device
from .ops import color
from .pipeline.live import (DetectorFn, LiveConfig, LiveOutput, LiveState,
                            MultiLiveState, _check_fused, _check_method,
                            _finish_batched, _fused_track, _multi_update,
                            _skin_track, _sos, _zero_multi_state,
                            _zero_state, pack_output, unpack_output)

__all__ = ["BpmServer", "init_state_batched", "serve_forever", "BpmClient",
           "WsBpmClient"]


def init_state_batched(cfg: LiveConfig, n_slots: int, k_faces: int = 1,
                       device=None):
    """A :class:`LiveState` (a :class:`MultiLiveState` for ``k_faces > 1``)
    with a leading ``(S,)`` slot axis, all zeros (a zeroed slot is a fresh
    slot)."""
    if k_faces > 1:
        return _zero_multi_state(cfg, (n_slots,), k_faces, device)
    return _zero_state(cfg, (n_slots,), device)


def _step_batched_impl(state, frames: torch.Tensor,
                       active: torch.Tensor, reset: torch.Tensor,
                       pool_phase: int, cfg: LiveConfig,
                       detector: Optional[DetectorFn], i420: bool = False,
                       k_faces: int = 1) -> Tuple[LiveState, torch.Tensor]:
    """One tick: advance all S slots from their ``(S, H, W, 3)`` frames
    (``(S, H*3//2, W)`` planar I420 frames when ``i420``) -> ``(state,
    packed (S, 10))``, or ``(S, K, 10)`` with ``k_faces > 1``.

    - ``reset[s]``: zero slot s's state first (a client just attached).
    - ``active[s]``: slot s received a frame this tick; an inactive slot
      advances nothing (no ring write, no budget drain, no frame_idx).
    - The fused tick's cadence is each slot's own frame counter.  The
      skin-detector tick's cadence (``detect_every > 1``) is the pool tick
      counter ``pool_phase``, a host integer: off-cadence ticks skip the
      detector for every slot.  For slots that never skip a tick both equal
      the single live step.
    """
    S = frames.shape[0]
    if i420:
        h, w = frames.shape[1] * 2 // 3, frames.shape[2]
        frames = color.i420_to_bgr_flat(frames, h, w).reshape(S, h, w, 3)
    state = type(state)(*(torch.where(
        reset.reshape((S,) + (1,) * (x.dim() - 1)), torch.zeros_like(x), x)
        for x in state))
    pool_attempt = pool_phase % cfg.detect_every == 0
    if k_faces > 1:
        new_state, out = _multi_update(state, frames, active & pool_attempt,
                                       active, cfg, k_faces, detector,
                                       pool_attempt)
        return new_state, pack_output(out)
    if cfg.use_fused:
        parts = _fused_track(state, frames, active, cfg)
    else:
        parts = _skin_track(state, frames, active & pool_attempt, active,
                            cfg, detector, pool_attempt)
    new_state, out = _finish_batched(state, cfg, _sos(cfg), active, *parts)
    return new_state, pack_output(out)


def _put(row: torch.Tensor, frame) -> None:
    """Copy one frame (numpy array or tensor) into a host batch row."""
    if isinstance(frame, np.ndarray):
        row.numpy()[...] = frame
    else:
        row.copy_(frame)


class BpmServer:
    """S-slot live BPM pool: one card, many monitored subjects.

    >>> srv = BpmServer(LiveConfig(fps=30.0), n_slots=8)
    >>> a, b = srv.attach(), srv.attach()
    >>> outs = srv.tick({a: frame_a, b: frame_b})   # one upload, one fetch
    >>> outs[a].bpm, outs[b].bpm

    All clients share one frame geometry per server.  Frames are ``(H, W,
    3)`` uint8 BGR numpy arrays or tensors (``(H*3//2, W)`` planar I420
    with ``transfer="i420"``); the state lives on ``device``:
    the CUDA card by default (raises without one), the CPU only with
    ``device="cpu"``.  ``k_faces > 1``: every slot monitors K subjects
    (``use_fused=False``), its outputs gain a ``(K,)`` axis, and
    ``detector`` follows the multi-face contract (``frames -> (boxes (S, K,
    4), valid (S, K))``).
    """

    def __init__(self, cfg: LiveConfig = LiveConfig(), n_slots: int = 8,
                 detector: Optional[DetectorFn] = None,
                 transfer: str = "bgr", mesh=None, k_faces: int = 1,
                 device=None):
        if cfg.use_fused:
            _check_fused(cfg, detector)
            if k_faces != 1:
                raise ValueError("use_fused is single-face per slot; "
                                 "k_faces>1 needs use_fused=False")
        if transfer not in ("bgr", "i420"):
            raise ValueError(f"transfer must be 'bgr' or 'i420', "
                             f"got {transfer!r}")
        if mesh is not None:
            raise NotImplementedError(
                "a pool sharded over devices is not yet ported (ROADMAP "
                "queue 1, item 14)")
        _check_method(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.n_slots = n_slots
        self.k_faces = k_faces
        self.transfer = transfer
        self._detector = detector
        self._lock = threading.Lock()
        self._attached = [False] * n_slots
        self._needs_reset = np.zeros((n_slots,), bool)
        self._state = init_state_batched(cfg, n_slots, k_faces, self.device)
        # A pool spans one process: the front-end's multi-host guard reads
        # this.
        self._multiproc = False
        self._tick_count = 0      # the skin-detector tick's cadence phase
        self._frame_shape: Optional[tuple] = None
        # Two pinned upload buffers, used in turn; the event recorded after
        # a buffer's copy is waited on before the buffer is written again.
        self._pinned: list = []
        self._turn = 0

    def attach(self) -> int:
        """Claim a free slot (its state zeroes on the next tick)."""
        with self._lock:
            for s in range(self.n_slots):
                if not self._attached[s]:
                    self._attached[s] = True
                    self._needs_reset[s] = True
                    return s
        raise RuntimeError(f"all {self.n_slots} slots busy")

    def detach(self, slot: int) -> None:
        with self._lock:
            self._attached[slot] = False

    def attached(self, slot: int) -> bool:
        with self._lock:
            return 0 <= slot < self.n_slots and self._attached[slot]

    @property
    def active_slots(self) -> list:
        with self._lock:
            return [s for s in range(self.n_slots) if self._attached[s]]

    # Snapshot schema: v2 keys the state by field name; v1 used positional
    # leaf{i} keys (restored only when the field count matches).
    _SNAP_SCHEMA = 2

    def snapshot(self) -> dict:
        """Serializable pool state (host numpy): every slot's state, the
        attach map and the cadence phase, keyed and typed as the JAX
        package's pool keys and types them, so either package restores the
        other's snapshot.  Save with ``np.savez(path, **snap)``."""
        with self._lock:
            fields = interop.live_state_to_numpy(self._state)
            snap = {f"state.{k}": v for k, v in fields.items()}
            snap["schema"] = np.int64(self._SNAP_SCHEMA)
            snap["attached"] = np.asarray(self._attached)
            snap["needs_reset"] = self._needs_reset.copy()
            snap["tick_count"] = np.int64(self._tick_count)
            return snap

    def restore(self, snap) -> None:
        """Inverse of :meth:`snapshot` (accepts an ``np.load`` mapping).

        v2 snapshots restore by field name; a field absent from the
        snapshot keeps its zero value, with a warning.  Legacy v1
        (positional ``leaf{i}``) snapshots are accepted only when the leaf
        count matches the state's field count."""
        with self._lock:
            cur = interop.live_state_to_numpy(self._state)
            if "schema" in snap or any(
                    str(k).startswith("state.") for k in snap):
                new = {}
                for k, v in cur.items():
                    key = f"state.{k}"
                    if key in snap:
                        new[k] = np.asarray(snap[key]).astype(v.dtype)
                    else:
                        print(f"[pool] snapshot lacks field {k!r} "
                              f"(older schema); keeping zero init",
                              file=sys.stderr)
                        new[k] = v
            else:
                n = sum(1 for k in snap if str(k).startswith("leaf"))
                if n != len(cur):
                    raise ValueError(
                        f"legacy snapshot has {n} leaves but the current "
                        f"pool state has {len(cur)} fields — re-snapshot "
                        f"with this version (schema v2)")
                new = {k: np.asarray(snap[f"leaf{i}"]).astype(v.dtype)
                       for i, (k, v) in enumerate(cur.items())}
            self._state = interop.live_state_from_numpy(
                new, self.device, multi=self.k_faces > 1)
            self._attached = [bool(b) for b in np.asarray(snap["attached"])]
            self._needs_reset = np.asarray(snap["needs_reset"]).copy()
            self._tick_count = int(snap["tick_count"])

    def tick(self, frames: Dict[int, object]) -> Dict[int, LiveOutput]:
        """Advance every slot that supplied a frame; one upload, one fetch.
        Slots without a frame this tick hold all state (a skipped camera
        frame, not a dropout)."""
        return self.fetch(self.tick_async(frames))

    def tick_async(self, frames: Dict[int, object]):
        """Like :meth:`tick` but returns the handle ``(slots, packed)``
        without waiting for the card; :meth:`fetch` materializes it, so the
        result's copy can overlap the next tick's host work."""
        if not frames:
            return None
        shape = tuple(next(iter(frames.values())).shape)
        if self._frame_shape is None:
            self._frame_shape = shape
        elif shape != self._frame_shape:
            raise ValueError(f"pool frame geometry is {self._frame_shape}; "
                             f"got {shape} (resize before the pool)")
        active = np.zeros((self.n_slots,), bool)
        with self._lock:
            for s in frames:
                if not self._attached[s]:
                    raise KeyError(f"slot {s} is not attached")
                active[s] = True
            reset = self._needs_reset.copy()
            self._needs_reset[:] = False
            batch = self._upload(frames, shape, active)
            masks = torch.from_numpy(np.stack([active, reset])).to(
                self.device, non_blocking=True)
            self._state, packed = _step_batched_impl(
                self._state, batch, masks[0], masks[1], self._tick_count,
                self.cfg, self._detector, self.transfer == "i420",
                self.k_faces)
            self._tick_count += 1
        return (list(frames), packed)

    def _upload(self, frames: Dict[int, object], shape: tuple,
                active: np.ndarray) -> torch.Tensor:
        """The ``(S,) + frame shape`` u8 batch on the pool's device; rows of
        slots without a frame are zero."""
        S = self.n_slots
        on_card = {s: f for s, f in frames.items()
                   if isinstance(f, torch.Tensor) and f.device == self.device}
        host = {s: f for s, f in frames.items() if s not in on_card}
        if self.device.type == "cpu":
            batch = torch.zeros((S,) + shape, dtype=torch.uint8)
            for s, f in frames.items():
                _put(batch[s], f)
            return batch
        if host:
            buf = self._pinned_buffer(shape)
            for s in range(S):
                if s in host:
                    _put(buf[s], host[s])
                elif not active[s]:
                    buf[s].zero_()
            batch = buf.to(self.device, non_blocking=True)
            self._pinned[self._turn][1].record()
            self._turn ^= 1
        else:
            batch = torch.empty((S,) + shape, dtype=torch.uint8,
                                device=self.device)
            for s in np.flatnonzero(~active):
                batch[s].zero_()
        for s, f in on_card.items():
            batch[s].copy_(f)
        return batch

    def _pinned_buffer(self, shape: tuple) -> torch.Tensor:
        if not self._pinned:
            self._pinned = [
                (torch.empty((self.n_slots,) + shape, dtype=torch.uint8,
                             pin_memory=True), torch.cuda.Event())
                for _ in range(2)]
        buf, done = self._pinned[self._turn]
        done.synchronize()        # the copy that last read this buffer
        return buf

    def fetch(self, handle) -> Dict[int, LiveOutput]:
        """Materialize a :meth:`tick_async` handle: the tick's one
        device-to-host copy."""
        if handle is None:
            return {}
        slots, packed = handle
        a = packed.cpu().numpy()
        return {s: unpack_output(a[s]) for s in slots}


# ---------------------------------------------------------------------------
# TCP front-end: length-prefixed frames in, JSON BPM lines out.
#
# Wire protocol (little-endian):
#   client -> server:  one JSON-object hello line, e.g.
#                      {"transfer": "bgr"}\n -- "transfer" MUST match the
#                      pool's configured wire format; optional
#                      "resume_slot": k reclaims a warm restored slot
#                      (attached in the snapshot, no live connection).
#                      Then per frame: u32 payload length + raw uint8 bytes
#                      (H*W*3 BGR, or (H*3/2)*W planar I420); length 0 = bye
#   server -> client:  {"slot": k} on accept (or {"error": ...} + hangup),
#                      then one JSON line per processed frame:
#       {"seq": k, "bpm": f, "bpm_valid": b, "face_valid": b, "box": [4]}
#       (k_faces > 1 pools send lists: one entry per monitored subject)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ClientConn:
    slot: int
    inbox: "queue.Queue[np.ndarray]"
    wfile: object
    seq: int = 0
    closing: bool = False
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    # Serializes BPM lines (tick thread) against error lines (handler
    # thread) on the same socket -- interleaved sendalls would corrupt the
    # JSON-lines stream.
    wlock: threading.Lock = dataclasses.field(default_factory=threading.Lock)


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            raise EOFError
        buf += chunk
    return buf


class _BpmTCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, pool: BpmServer, frame_shape: tuple,
                 max_queue: int = 64, io_timeout: float = 300.0,
                 auth_token: Optional[str] = None,
                 ws_origins: Optional[tuple] = None):
        self.pool = pool
        self.frame_shape = tuple(frame_shape)
        self.max_queue = max_queue
        # Access control: BPM output is physiological data.  auth_token
        # (when set) must match the hello's {"token": ...} on BOTH
        # protocols.  ws_origins governs *browser* clients: a WebSocket
        # upgrade that carries an Origin header is rejected unless the
        # origin is allow-listed (or ws_origins is ("*",)) — by default
        # NO browser origin is accepted, so a random webpage (or a DNS
        # rebinding page) on the operator's LAN cannot silently attach
        # pool slots.  Non-browser WS clients send no Origin and are
        # governed by auth_token alone.
        self.auth_token = auth_token
        self.ws_origins = tuple(ws_origins) if ws_origins else ()
        # One socket timeout covers reads AND writes: a client that stops
        # READING its BPM lines would otherwise block the tick thread's
        # sendall forever (head-of-line DoS on the whole pool); a client
        # idle longer than this is dropped cleanly.
        self.io_timeout = io_timeout
        # Live telemetry (read by the {"stats": true} hello): tick-duration
        # EMA + totals, so operators can watch pool load without a profiler.
        self.stats = {"ticks": 0, "frames": 0, "tick_ms_ema": 0.0,
                      "tick_errors": 0}
        self.clients: Dict[int, _ClientConn] = {}
        self.clients_lock = threading.Lock()
        self._stop = threading.Event()
        super().__init__(addr, _BpmHandler)
        self._tick_thread = threading.Thread(target=self._tick_loop,
                                             daemon=True)
        self._tick_thread.start()

    def _tick_loop(self):
        """Drain one frame per connected client per tick — every frame is
        processed, in order, and the batch dimension is the economy.  Slot
        release is owned HERE (after the inbox drains), so a tick never
        races a handler's detach.

        The loop is 1-deep PIPELINED (the ``LivePipeline`` overlap, lifted
        to the pool): tick N+1 dispatches before tick N's packed result is
        fetched, so the result round trip (PCIe/grpc/relay) overlaps the
        next tick's host work.  Answer lag is at most one tick; when no new
        frames arrive the pending tick flushes immediately, so idle-pool
        latency is unchanged."""
        import time
        pending = None                        # (outs_for, handle, t0)
        while not self._stop.is_set():
            with self.clients_lock:
                conns = list(self.clients.values())
            frames, outs_for = {}, []
            for c in conns:
                try:
                    frames[c.slot] = c.inbox.get_nowait()
                    outs_for.append(c)
                except queue.Empty:
                    if c.closing and pending is None:
                        with self.clients_lock:
                            self.clients.pop(c.slot, None)
                        self.pool.detach(c.slot)
                        c.done.set()
            if not frames and pending is None:
                time.sleep(0.001)
                continue
            t0 = time.perf_counter()
            handle = None
            if frames:
                try:
                    handle = self.pool.tick_async(frames)
                except Exception as e:       # noqa: BLE001 -- one bad tick
                    # must not kill the only thread serving the pool:
                    # answer the affected clients and keep going.
                    self._answer_error(outs_for, e)
                    handle = None
            prev, pending = pending, ((outs_for, handle, t0)
                                      if handle is not None else None)
            if prev is None:
                continue
            outs_for, handle, t0 = prev
            try:
                outs = self.pool.fetch(handle)   # blocks on tick N-1 only
            except Exception as e:               # noqa: BLE001
                self._answer_error(outs_for, e)
                self.stats["tick_errors"] += 1
                continue
            dt_ms = (time.perf_counter() - t0) * 1e3
            st = self.stats
            st["ticks"] += 1
            st["frames"] += len(outs)
            st["tick_ms_ema"] = (dt_ms if st["ticks"] == 1 else
                                 0.95 * st["tick_ms_ema"] + 0.05 * dt_ms)
            multi = self.pool.k_faces > 1
            for c in outs_for:
                o = outs[c.slot]
                if multi:   # one entry per monitored subject (K,)
                    msg = {"seq": c.seq,
                           "bpm": np.round(np.asarray(o.bpm), 4).tolist(),
                           "bpm_valid": np.asarray(o.bpm_valid).tolist(),
                           "face_valid": np.asarray(o.face_valid).tolist(),
                           "box": np.asarray(o.box).tolist()}
                else:
                    msg = {"seq": c.seq, "bpm": round(float(o.bpm), 4),
                           "bpm_valid": bool(o.bpm_valid),
                           "face_valid": bool(o.face_valid),
                           "box": [int(x) for x in np.asarray(o.box)]}
                if self.pool.cfg.method == "adaptive":
                    # Which pulse construction (an index into
                    # cfg.adaptive_methods) won this tick.
                    ms = self.pool.cfg.adaptive_methods
                    ch = np.asarray(o.choice)
                    msg["method"] = ([ms[int(k)] for k in ch.ravel()]
                                     if multi else ms[int(ch)])
                line = json.dumps(msg) + "\n"
                c.seq += 1
                with c.wlock:
                    try:
                        c.wfile.write(line.encode())
                        c.wfile.flush()
                    except OSError:          # dead or stalled reader
                        c.closing = True     # (io_timeout) -- drop it

    def _answer_error(self, outs_for, e) -> None:
        err = (json.dumps({"error": f"tick failed: {e!r}"}) + "\n").encode()
        for c in outs_for:
            with c.wlock:
                try:
                    c.wfile.write(err)
                    c.wfile.flush()
                except OSError:
                    c.closing = True
        self.stats["tick_errors"] += 1

    def shutdown(self):
        self._stop.set()
        super().shutdown()


# --- WebSocket (RFC 6455) wire layer: first-party, stdlib + numpy only ---

_WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


class _WsClosed(Exception):
    """Peer sent a close frame (clean WebSocket end)."""


class _FramePayloadError(ValueError):
    """A protocol-level frame error worth answering before hangup."""


def _ws_send(wfile, payload: bytes, opcode: int) -> None:
    """One unmasked server->client frame (servers MUST NOT mask)."""
    b0 = 0x80 | opcode                                   # FIN + opcode
    n = len(payload)
    if n < 126:
        hdr = bytes((b0, n))
    elif n < 65536:
        hdr = bytes((b0, 126)) + struct.pack(">H", n)
    else:
        hdr = bytes((b0, 127)) + struct.pack(">Q", n)
    wfile.write(hdr + payload)
    wfile.flush()


def _ws_mask(payload: bytes, mask: bytes) -> bytes:
    """XOR (un)masking, vectorized — frame payloads are whole camera
    frames, so the per-byte Python loop in most textbook implementations
    would dominate the wire cost."""
    n = len(payload)
    if n == 0:
        return payload
    a = np.frombuffer(payload, np.uint8)
    m = np.frombuffer(mask, np.uint8)
    pad = (-n) % 4
    if pad:
        a = np.concatenate([a, np.zeros(pad, np.uint8)])
    return (a.reshape(-1, 4) ^ m).tobytes()[:n]


def _ws_read_frame(rfile, max_len: int, require_mask: bool = True):
    """One raw frame -> (fin, opcode, unmasked payload).  Servers pass
    ``require_mask=True`` (client data frames MUST be masked per RFC
    6455); clients read unmasked server frames with ``False``."""
    hdr = _read_exact(rfile, 2)
    if hdr[0] & 0x70:
        raise ValueError("RSV bits set (extensions not negotiated)")
    fin = bool(hdr[0] & 0x80)
    op = hdr[0] & 0x0F
    masked = bool(hdr[1] & 0x80)
    n = hdr[1] & 0x7F
    if op >= 8:                                  # control frame rules
        if not fin:
            raise ValueError("fragmented control frame (RFC 6455 5.5)")
        if n > 125:
            raise ValueError("control frame payload > 125 (RFC 6455 5.5)")
    if n == 126:
        (n,) = struct.unpack(">H", _read_exact(rfile, 2))
    elif n == 127:
        (n,) = struct.unpack(">Q", _read_exact(rfile, 8))
    if n > max_len + 16:
        raise ValueError(f"frame too long ({n} > {max_len})")
    if require_mask and not masked:
        # ALL client frames must be masked, control frames included
        # (RFC 6455 5.1) — not just data opcodes.
        raise ValueError("client frames must be masked (RFC 6455)")
    mask = _read_exact(rfile, 4) if masked else b""
    payload = _read_exact(rfile, n)
    if masked:
        payload = _ws_mask(payload, mask)
    return fin, op, payload


class _WsWriter:
    """File-like adapter for :class:`_ClientConn`: each ``.write()`` is
    framed as ONE text message (the tick loop writes exactly one JSON line
    per call).  No internal locking — callers hold the conn's ``wlock``,
    same as the raw-TCP path."""

    def __init__(self, wfile):
        self._wfile = wfile

    def write(self, data: bytes) -> None:
        _ws_send(self._wfile, data, 0x1)

    def flush(self) -> None:
        pass


class _BpmHandler(socketserver.StreamRequestHandler):
    def _error(self, msg: str, conn=None, writer=None) -> None:
        w = writer if writer is not None else self.wfile
        data = (json.dumps({"error": msg}) + "\n").encode()
        try:
            if conn is not None:
                with conn.wlock:
                    w.write(data)
                    w.flush()
            else:
                w.write(data)
                w.flush()
        except OSError:
            pass

    def handle(self):
        srv: _BpmTCPServer = self.server
        self.connection.settimeout(srv.io_timeout)
        try:
            line = self.rfile.readline(65537)
        except OSError:
            return
        # One port, two protocols: a WebSocket upgrade starts with an HTTP
        # request line; the raw-TCP protocol starts with a JSON hello.
        if line.startswith(b"GET"):
            self._handle_ws(line)
        else:
            self._handle_tcp(line)

    def _parse_hello(self, raw: bytes):
        """Shared hello validation -> (hello, transfer, resume).  Raises
        ValueError on anything malformed (the pool is untouched)."""
        srv: _BpmTCPServer = self.server
        if len(raw) > 65536:
            raise ValueError("hello too long")
        hello = json.loads(raw.decode() or "{}")
        if not isinstance(hello, dict):
            raise ValueError("hello must be a JSON object")
        if srv.auth_token is not None and not hmac.compare_digest(
                str(hello.get("token", "")), srv.auth_token):
            # constant-time compare: the token is a shared secret arriving
            # over the network (ADVICE r4)
            raise ValueError("bad or missing auth token")
        transfer = hello.get("transfer", "bgr")
        if not hello.get("stats") and transfer != srv.pool.transfer:
            raise ValueError(
                f"pool expects transfer={srv.pool.transfer!r}, "
                f"client sent {transfer!r}")
        resume = hello.get("resume_slot")
        if resume is not None and not isinstance(resume, int):
            raise ValueError("resume_slot must be an integer")
        return hello, transfer, resume

    def _handle_tcp(self, line: bytes):
        try:
            hello, transfer, resume = self._parse_hello(line)
        except (ValueError, UnicodeDecodeError) as e:
            self._error(f"bad hello: {e}")
            return

        def make_recv(nbytes, shape, conn):
            def recv():
                (n,) = struct.unpack("<I", _read_exact(self.rfile, 4))
                if n == 0:
                    return None
                if n != nbytes:
                    raise _FramePayloadError(
                        f"frame payload {n} != expected {nbytes} "
                        f"for {transfer}")
                return np.frombuffer(_read_exact(self.rfile, n),
                                     np.uint8).reshape(shape)
            return recv

        self._session(hello, transfer, resume, self.wfile, make_recv)

    # --- WebSocket path -----------------------------------------------------

    def _handle_ws(self, request_line: bytes):
        srv: _BpmTCPServer = self.server
        headers = {}
        try:
            while True:
                l = self.rfile.readline(65537)
                if l in (b"\r\n", b"\n", b""):
                    break
                if b":" in l:
                    k, v = l.split(b":", 1)
                    headers[k.strip().lower()] = v.strip()
            key = headers.get(b"sec-websocket-key")
            if (headers.get(b"upgrade", b"").lower() != b"websocket"
                    or key is None):
                self.wfile.write(b"HTTP/1.1 400 Bad Request\r\n"
                                 b"Connection: close\r\n\r\n")
                self.wfile.flush()
                return
            origin = headers.get(b"origin")
            if origin is not None:
                # Browser-originated upgrade: enforce the allowlist (a
                # webpage cannot speak the raw-TCP protocol, but it CAN
                # open a WebSocket to any host the browser reaches —
                # including via DNS rebinding).  Default: deny all.
                try:
                    o = origin.decode("ascii")
                except UnicodeDecodeError:
                    o = None
                if not ("*" in srv.ws_origins or
                        (o is not None and o in srv.ws_origins)):
                    self.wfile.write(b"HTTP/1.1 403 Forbidden\r\n"
                                     b"Connection: close\r\n\r\n")
                    self.wfile.flush()
                    return
            accept = base64.b64encode(
                hashlib.sha1(key + _WS_GUID).digest())
            self.wfile.write(
                b"HTTP/1.1 101 Switching Protocols\r\n"
                b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                b"Sec-WebSocket-Accept: " + accept + b"\r\n\r\n")
            self.wfile.flush()
        except OSError:
            return
        writer = _WsWriter(self.wfile)
        try:
            op, data = self._ws_read_message(None, 65536)
            if op != 1:
                raise ValueError("hello must be a text message")
            hello, transfer, resume = self._parse_hello(data)
        except (_WsClosed, EOFError, OSError):
            return
        except (ValueError, UnicodeDecodeError) as e:
            self._error(f"bad hello: {e}", writer=writer)
            return

        def make_recv(nbytes, shape, conn):
            def recv():
                while True:
                    try:
                        op, data = self._ws_read_message(
                            conn, max(nbytes, 65536))
                    except _WsClosed:
                        return None
                    if op == 1:            # text mid-stream: only "bye"
                        try:
                            msg = json.loads(data.decode())
                        except (ValueError, UnicodeDecodeError):
                            raise _FramePayloadError("bad text message")
                        if msg.get("bye"):
                            return None
                        continue
                    if len(data) != nbytes:
                        raise _FramePayloadError(
                            f"frame payload {len(data)} != expected "
                            f"{nbytes} for {transfer}")
                    return np.frombuffer(data, np.uint8).reshape(shape)
            return recv

        self._session(hello, transfer, resume, writer, make_recv)

    def _ws_read_message(self, conn, max_len: int):
        """Next data message -> (opcode, payload bytes): assembles
        fragments, answers pings in place (under the conn's write lock so
        pongs never interleave with tick-thread BPM lines), raises
        :class:`_WsClosed` on a close frame (after echoing it)."""
        first_op, buf = None, b""
        while True:
            fin, op, payload = _ws_read_frame(self.rfile, max_len)
            if op == 8:                                   # close
                self._ws_control(conn, 8, payload[:125])
                raise _WsClosed
            if op == 9:                                   # ping -> pong
                self._ws_control(conn, 10, payload)
                continue
            if op == 10:                                  # unsolicited pong
                continue
            if op in (1, 2):
                if first_op is not None:
                    raise ValueError("new message mid-fragment")
                if fin:
                    return op, payload
                first_op, buf = op, payload
            elif op == 0:
                if first_op is None:
                    raise ValueError("continuation without a start frame")
                buf += payload
                if len(buf) > max_len + 16:
                    raise ValueError("fragmented message too long")
                if fin:
                    return first_op, buf
            else:
                raise ValueError(f"unsupported opcode {op}")

    def _ws_control(self, conn, opcode: int, payload: bytes) -> None:
        try:
            if conn is not None:
                with conn.wlock:
                    _ws_send(self.wfile, payload, opcode)
            else:
                _ws_send(self.wfile, payload, opcode)
        except OSError:
            pass

    # --- protocol-agnostic slot session --------------------------------------

    def _session(self, hello: dict, transfer: str, resume, writer,
                 make_recv):
        """Everything after a validated hello, shared by both protocols:
        stats reply, slot attach/resume, frame pump into the tick loop's
        inbox, and teardown.  ``writer`` frames one JSON line per
        ``.write()`` (raw wfile for TCP, :class:`_WsWriter` for WS);
        ``make_recv(nbytes, shape, conn)`` builds the per-protocol frame
        reader (returns an array per frame, ``None`` on clean end, raises
        :class:`_FramePayloadError` on protocol errors)."""
        srv: _BpmTCPServer = self.server
        if hello.get("stats"):
            with srv.clients_lock:
                connected = len(srv.clients)
            payload = dict(srv.stats,
                           slots=srv.pool.n_slots,
                           attached=len(srv.pool.active_slots),
                           connected=connected,
                           k_faces=srv.pool.k_faces,
                           transfer=srv.pool.transfer,
                           height=srv.frame_shape[0],
                           width=srv.frame_shape[1])
            payload["tick_ms_ema"] = round(payload["tick_ms_ema"], 3)
            try:
                writer.write((json.dumps(payload) + "\n").encode())
                writer.flush()
            except OSError:
                pass
            return
        h, w = srv.frame_shape
        nbytes = (h * 3 // 2) * w if transfer == "i420" else h * w * 3
        shape = (h * 3 // 2, w) if transfer == "i420" else (h, w, 3)
        conn = _ClientConn(slot=-1,
                           inbox=queue.Queue(maxsize=srv.max_queue),
                           wfile=writer)
        if resume is not None:
            # Reclaim a warm restored slot: attached in the pool (the
            # snapshot's attach map) but with no live connection.  The
            # check and the registration are atomic under clients_lock so
            # two resumers cannot adopt the same slot.
            with srv.clients_lock:
                if resume in srv.clients or not srv.pool.attached(resume):
                    self._error(f"slot {resume} is not resumable",
                                writer=writer)
                    return
                conn.slot = slot = resume        # no reset: state is warm
                srv.clients[slot] = conn
        else:
            try:
                slot = srv.pool.attach()
            except RuntimeError as e:
                self._error(str(e), writer=writer)
                return
            conn.slot = slot
            with srv.clients_lock:
                srv.clients[slot] = conn
        recv_frame = make_recv(nbytes, shape, conn)
        try:
            with conn.wlock:
                writer.write((json.dumps({"slot": slot}) + "\n").encode())
                writer.flush()
            while True:
                frame = recv_frame()
                if frame is None:
                    break
                while not conn.closing:      # don't wedge on a full inbox
                    try:                     # after the tick loop drops us
                        conn.inbox.put(frame, timeout=1.0)
                        break
                    except queue.Full:
                        continue
                if conn.closing:
                    break
        except _FramePayloadError as e:
            self._error(str(e), conn, writer)
            # hang up; queued frames still drain
        except (ValueError, EOFError, OSError):
            pass
        finally:
            # The tick loop owns slot release: it drains the inbox (every
            # accepted frame is answered), then detaches and signals.
            conn.closing = True
            conn.done.wait(timeout=30.0)


def serve_forever(host: str, port: int, pool: BpmServer,
                  frame_shape: tuple, io_timeout: float = 300.0,
                  auth_token: Optional[str] = None,
                  ws_origins: Optional[tuple] = None) -> _BpmTCPServer:
    """Start the TCP front-end on a background thread; returns the server
    (``.server_address`` has the bound port; call ``.shutdown()``).

    ``auth_token``: when set, every hello (raw TCP and WebSocket, stats
    included) must carry a matching ``{"token": ...}`` field.
    ``ws_origins``: allowlist for *browser* WebSocket upgrades — an
    upgrade carrying an Origin header is rejected with 403 unless its
    origin is listed (``("*",)`` allows any).  Default: deny all browser
    origins.  Either way, do not expose the port beyond trusted hosts
    without a token — BPM streams are physiological data.

    Multi-host pools are rejected: the tick loop here is driven by
    host-local client traffic, but a multi-process pool's tick/fetch/
    snapshot contain collectives and MUST run the same call sequence on
    every host.  (The port's pools span one process.)"""
    if pool._multiproc:
        raise ValueError(
            "serve_forever drives ticks from host-local client traffic; "
            "a multi-host pool must run the SPMD tick sequence on every "
            "host (tick/fetch/snapshot contain collectives — see "
            "BpmServer and tests/dcn_worker.py)")
    srv = _BpmTCPServer((host, port), pool, frame_shape,
                        io_timeout=io_timeout, auth_token=auth_token,
                        ws_origins=ws_origins)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv


class BpmClient:
    """Minimal client for the TCP protocol (test + reference harness).

    >>> c = BpmClient("127.0.0.1", port)
    >>> c.send(frame); out = c.recv()      # dicts per processed frame
    """

    def __init__(self, host: str, port: int, transfer: str = "bgr",
                 timeout: float = 30.0, resume_slot: Optional[int] = None,
                 token: Optional[str] = None):
        """``resume_slot``: reclaim a warm slot after a server restart
        with ``--restore`` (the snapshot keeps the attach map).
        ``token``: shared secret for servers started with
        ``auth_token``."""
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.rfile = self.sock.makefile("rb")
        self.transfer = transfer
        hello = {"transfer": transfer}
        if resume_slot is not None:
            hello["resume_slot"] = resume_slot
        if token is not None:
            hello["token"] = token
        self.sock.sendall((json.dumps(hello) + "\n").encode())
        accept = json.loads(self.rfile.readline().decode())
        if "error" in accept:
            self.sock.close()
            raise ConnectionError(accept["error"])
        self.slot = accept["slot"]

    def send(self, frame: np.ndarray) -> None:
        raw = np.ascontiguousarray(frame, np.uint8).tobytes()
        self.sock.sendall(struct.pack("<I", len(raw)) + raw)

    def recv(self) -> dict:
        return json.loads(self.rfile.readline().decode())

    def close(self) -> None:
        try:
            self.sock.sendall(struct.pack("<I", 0))
        except OSError:
            pass
        self.sock.close()


class WsBpmClient:
    """WebSocket counterpart of :class:`BpmClient` (same surface: ``slot``,
    ``send``, ``recv``, ``close``) — masks client frames per RFC 6455, so
    it exercises exactly the path a browser takes.  ``hello_extra`` merges
    extra hello fields (e.g. ``{"stats": True}`` -> the reply lands in
    ``self.stats`` and ``slot`` is ``None``)."""

    def __init__(self, host: str, port: int, transfer: str = "bgr",
                 timeout: float = 30.0, resume_slot: Optional[int] = None,
                 hello_extra: Optional[dict] = None,
                 token: Optional[str] = None,
                 origin: Optional[str] = None):
        """``token``: shared secret for ``auth_token`` servers.
        ``origin``: send an Origin header (what a browser does) — the
        server rejects it with 403 unless allow-listed via
        ``ws_origins``."""
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.rfile = self.sock.makefile("rb")
        self.transfer = transfer
        key = base64.b64encode(os.urandom(16)).decode()
        req = (f"GET /bpm HTTP/1.1\r\nHost: {host}:{port}\r\n"
               f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
               + (f"Origin: {origin}\r\n" if origin is not None else "")
               + f"Sec-WebSocket-Key: {key}\r\n"
               f"Sec-WebSocket-Version: 13\r\n\r\n")
        self.sock.sendall(req.encode())
        status = self.rfile.readline()
        if b"101" not in status:
            self.sock.close()
            raise ConnectionError(f"handshake refused: {status!r}")
        want = base64.b64encode(
            hashlib.sha1(key.encode() + _WS_GUID).digest())
        got = None
        while True:
            l = self.rfile.readline()
            if l in (b"\r\n", b"\n", b""):
                break
            if l.lower().startswith(b"sec-websocket-accept:"):
                got = l.split(b":", 1)[1].strip()
        if got != want:
            self.sock.close()
            raise ConnectionError("bad Sec-WebSocket-Accept")
        hello = {"transfer": transfer}
        if resume_slot is not None:
            hello["resume_slot"] = resume_slot
        if token is not None:
            hello["token"] = token
        if hello_extra:
            hello.update(hello_extra)
        self._send_msg(json.dumps(hello).encode(), 0x1)
        first = json.loads(self._recv_text())
        self.stats: Optional[dict] = None
        self.slot: Optional[int] = None
        if hello.get("stats"):
            self.stats = first
        elif "error" in first:
            self.sock.close()
            raise ConnectionError(first["error"])
        else:
            self.slot = first["slot"]

    def _send_msg(self, payload: bytes, opcode: int) -> None:
        b0 = 0x80 | opcode
        n = len(payload)
        if n < 126:
            hdr = bytes((b0, 0x80 | n))
        elif n < 65536:
            hdr = bytes((b0, 0x80 | 126)) + struct.pack(">H", n)
        else:
            hdr = bytes((b0, 0x80 | 127)) + struct.pack(">Q", n)
        mask = os.urandom(4)
        self.sock.sendall(hdr + mask + _ws_mask(payload, mask))

    def _recv_text(self) -> str:
        first_op, buf = None, b""
        while True:
            fin, op, payload = _ws_read_frame(self.rfile, 1 << 20,
                                              require_mask=False)
            if op == 8:
                raise ConnectionError("server closed")
            if op == 9:
                self._send_msg(payload, 0xA)             # pong
                continue
            if op == 10:
                continue
            if op in (1, 2):
                if fin:
                    return payload.decode()
                first_op, buf = op, payload
            elif op == 0:
                buf += payload
                if fin:
                    return buf.decode()

    def send(self, frame: np.ndarray) -> None:
        self._send_msg(np.ascontiguousarray(frame, np.uint8).tobytes(), 0x2)

    def recv(self) -> dict:
        return json.loads(self._recv_text())

    def close(self) -> None:
        try:
            self._send_msg(json.dumps({"bye": True}).encode(), 0x1)
            self._send_msg(b"", 0x8)
        except OSError:
            pass
        self.sock.close()
