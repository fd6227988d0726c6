"""The port's single-card entry point, the counterpart of
``__graft_entry__.py::entry``.

``entry()`` returns ``(forward, example_args)``: the flagship offline
measure as one function of uint8 frames, and the JAX entry's example clip
(5 s at 30 fps, 96 x 128, a 75 BPM skin ellipse from ``utils.synth``) on
the device.  ``forward(frames) -> (bpm (T,), valid (T,))``.

    python -m vhr_tpu_torch.entry [--device cpu]

On the CUDA card ``forward`` runs the fused form (kernel K1); on the CPU
the detect-then-reduce form.  It forward-fills the trace over dropouts
before the rolling FFT BPM, as ``pipeline.offline.measure_green_avg``
does (the JAX entry does not; on its clip, whose trace is all valid, the
fill is the identity).  The multi-device dry run waits for the port's
multi-device item (ROADMAP queue 1, item 14).
"""

from __future__ import annotations

import torch

from .config import PipelineConfig
from .device import resolve_device

__all__ = ["entry"]


def entry(device=None):
    """``(forward, example_args)`` of the flagship offline measure on
    ``device`` (the CUDA card by default; raises without one)."""
    from .ops import windows as vwin
    from .pipeline import offline
    from .utils.synth import SynthSpec, synthesize

    dev = resolve_device(device)
    fps = 30.0
    cfg = PipelineConfig(window_seconds=4.0, acquisition_seconds=2.0)
    use_fused = dev.type == "cuda"

    def forward(frames: torch.Tensor):
        trace = offline.extract_signals(frames, cfg, use_pallas=use_fused)
        green = offline._fill_invalid(trace.bgr[:, cfg.channel], trace.valid)
        rolling = vwin.rolling_bpm_fft(green, fps, cfg.band,
                                       cfg.window_len(fps),
                                       cfg.acquisition_len(fps))
        return rolling.bpm, rolling.valid & trace.valid

    clip = synthesize(SynthSpec(duration_s=5.0, height=96, width=128,
                                bpm=75.0))
    return forward, (torch.as_tensor(clip.frames, device=dev),)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run the port's entry() once")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "on the host)")
    args = p.parse_args(argv)
    fn, example = entry(args.device)
    bpm, valid = fn(*example)
    print(f"entry() ran: bpm {tuple(bpm.shape)}, "
          f"{int(valid.sum())} valid frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
