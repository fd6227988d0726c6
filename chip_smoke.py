#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``vhr_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. build the CUDA kernels from ``vhr_tpu_torch/csrc`` (one nvcc per source,
   all started together, sm_90a);
2. make a 1080p, T=960 (32 s at 30 fps) face clip on the card from a
   seeded ``torch.Generator``: a skin ellipse on a dark background whose
   green channel pulses at 72 BPM, with a small sway and sensor noise;
3. hold each kernel against its plain PyTorch version on the card: K2 and
   K3 (one source, ``csrc/roi_means.cu``) on the clip's cheek ROIs plus
   random, degenerate and negative-``y1`` ROIs (K3 also on a stream's
   256-frame chunk and on rows padded to a wider pitch; K2 later also on
   the skin pool's 64 slots of 720p), each on the instance its plan takes
   and on the generic one, equal bit for bit, K1 over its knobs
   (row pooling 1, 2, 4 and 8, detection cadence, gating, multi-stream
   ``seq_len``) on the clip and from a base off the 16-byte grid (its
   scalar skin pass) on the clip's first 64 frames, K4 on 64 slots of
   720p frames with random carries (fresh, tracked, spent budgets, a
   cheek ROI across a row-chunk boundary, a ROI clipped at the frame's
   right and bottom edge) and random phases over the same knobs, and
   with a long ROI that runs into a chunk the gate leaves out; integer
   outputs must be equal, means within ``rtol=1e-6`` (K1's and K4's
   equal); the acquisition ramp's kernel (``csrc/ramp_dft.cu``, one
   launch) on 8 traces of 960 frames at the skin cell's lengths (300 to
   900): valid equal, bpm equal but where the plain version's top two
   in-band magnitudes lie within a relative 1e-5;
4. the offline green-channel measure at the flagship configuration (30 s
   window / 10 s acquisition) in both forms — fused (K1,
   ``detect_row_pool=8``) and detect-then-reduce with the K2 ROI kernel:
   every kernel launched, >= 95% of post-acquisition frames valid, and the
   BPM within 0.5 BPM (MAE) of the frame-at-a-time numpy reference run on
   the port's own green trace;
5. the other offline measures at the same configuration, each in the
   fused form (K1) and the ``"roi"`` form (K2), a launch in every call:
   ``measure_projection`` for CHROM, POS and OMIT, ``measure_adaptive``,
   ``measure_ica``, ``measure_app_welch`` and ``measure_green_avg`` with
   ``estimator="welch"``.  Each must have >= 95% of the frames from its
   first estimate on valid (the acquisition's end for the FFT measures,
   the full window for the Welch ones; >= 90% from ``ICAConfig``'s
   acquisition for ICA) and the median BPM over valid steady frames within
   3 BPM of the truth (6 for ICA).  Each measure's trace is copied to the
   CPU and the same port DSP run there: BPM equal on >= 99% of the
   frames valid on both, validity and the adaptive choice equal (ICA's
   validity on >= 97% of frames: its float32 convergence test decides
   windows that hover at ``tol`` by the last bits of cuSOLVER's and
   LAPACK's results); a second call on the card gives the same bits.  Times: the whole measure and the DSP after
   the trace by events, the DSP's device operations and busy time under
   the profiler, and the app loop's zero-phase filter on its own;
6. streaming ingest from a file: the flagship clip's first 448 frames
   (14.9 s; 704 before the training phase, 960 before multi-device)
   written to an MJPG
   ``.avi`` with the port's ``write_video`` and read back whole with
   ``read_video``; ``extract_signals_streaming`` at ``chunk_frames=256`` (2
   chunks, the last 192 frames) in the detect-then-reduce form (ROI means
   on K3) and the fused form (one K1 launch per chunk, carry on the card):
   each equal to the port's whole-clip pass in the same form on the
   read-back frames.  The fused stream again with 4 cv2 decoders: equal
   bit for bit to one decoder's, K1 once a chunk; the reader alone with 1
   and 4 decoders (frames/s, pinned bytes) and an mp4v copy of the clip's
   first 240 frames read with 1 and 4 decoders (equal bytes: the seeks of
   an inter-frame codec).  Then I420 staging: the card's
   ``i420_to_bgr_flat`` equal bit for bit to cv2's ``COLOR_YUV2BGR_I420``
   of the host's ``COLOR_BGR2YUV_I420`` planes on all 448 frames; the
   fused I420 stream (K1 once a chunk) equal bit for bit to
   ``extract_signals_fused`` on those rebuilt frames, the detect I420
   stream (plane means, no K3) with the same ``valid`` as the whole-clip
   detect pass on them and means within 1.5 u8; each I420 stream >= 95 %
   of post-acquisition frames valid with BPM MAE <= 0.5 against the numpy
   reference on its own trace.  Then ``measure_green_avg_file`` (fused):
   >= 95% of post-acquisition frames valid, BPM MAE at most 0.5 against
   the numpy reference on its green trace.  Prints frames/s from the file
   (decode included), the decode-or-device verdict and the peak device
   memory of every stream and of the whole-clip calls, and the
   reconstruction's and the plane means' times on one chunk;
7. the Eulerian colour-magnification (EVM) path at 1080p.  K6 (blur,
   decimate, YIQ) and K7 (upsample, add, u8 reconstruction) against their
   plain versions on the flagship clip's first 64 frames and on a 720p
   slice of them (K6 also at a width of 1000 and at 1917x1079; K7 on the
   band the pipeline makes and on a random band of +-0.5, in both
   layouts): K6 within 1e-6,
   K7 within 1 u8 on at most 1e-3 of the values, and its vectorised
   instance (interleaved frames at 1080p and 720p) equal bit for bit to its
   generic one.  Then ``magnify`` with
   ``EVMConfig()`` on a T=600 clip (the app's 20 s chunk) with a 55 BPM
   pulse: K6 and K7 launched (K7's vectorised instance), u8 of the input's
   shape, the cheek's green
   pulse amplified more than 5x, the kernel route within 2 u8 of the plain
   route at T=64.  Then the EVM measure (``_measure_frames``) on the
   flagship clip: K6 launched, >= 95% of post-acquisition frames valid, BPM
   MAE at most 4 against the 72 BPM truth, and at T=64 the kernel route's
   pulse trace within ``rtol=1e-3, atol=1e-6`` of the plain route's;
8. the production MediaPipe detector (the bundled BlazeFace and 478-point
   mesh nets, uncut) on a 1080p, T=960 clip of the schematic face of
   ``tests/test_mediapipe_face.py`` drawn 4.2x its size with cv2, swaying
   3 px, a 72 BPM green pulse on its skin ellipse and 0-7 u8 noise, made on
   the card.  K5 against its plain version at the mesh net's four stage
   shapes with the bundled weights, B=64 and B=1 (the detector's slice
   and the live step's one frame a call), float32 (within 1e-5 of max|y|:
   its 1x1 convs keep about 22 bits of each product in three TF32 passes)
   and bfloat16 (one bf16 ulp, or 1e-5 of max|y| near zero); the float32
   executor, unfused and with its stages on K5, against the numpy oracle on
   a letterboxed frame and a face crop (the JAX package's bounds, 2e-5 and
   3e-4 of max|y|).  Then ``measure_green_avg(detector=...,
   use_pallas="roi")`` with the detector of ``load_face_models(
   fuse_stages=True)`` at the product default (bf16 activations, axis
   crop): K5 and K2 launched, >= 95% of post-acquisition frames valid, BPM
   MAE at most 0.5 against the numpy reference on its green trace, the
   landmark box's IoU with the skin ellipse's box at least 0.5 on every
   valid frame.  The unfused detector must agree: validity equal on >= 99%
   of frames, landmark RMS within the JAX package's bf16 bound (1.5 px on
   its test face, taken into the mesh net's 256-px crop with the ROI the
   detector finds on that face here).  The product detector
   (``make_mediapipe_detector()``, what ``--detector mediapipe`` gives the
   apps and the sweep) one frame a call on 8 frames, as the live step
   calls it: K5 launched 4 times a call, and the same two bounds against
   the unfused nets at B=1.  Times: the measure
   and detection alone, fused and unfused, the card's busy share in one
   profiled run of the fused measure; K5 per stage, its plain version and
   the same 25 ops unfused (cuDNN, op by op);
8b. the rest of the MediaPipe family.  Two of phase 8's faces side by
   side at 1080p (360 frames, 60 and 96 BPM, made on the card from a
   seed) through ``measure_green_avg_multi`` with
   ``make_mediapipe_detector_multi(k_faces=2)``: K5 launched, each face
   >= 95% valid after the acquisition (10 s windows) with its last valid
   BPM within 8 BPM of its rate, the boxes in x-order; K5 against its plain
   version at the batch that detector gives it (B=128: two crops a frame,
   slices of 64), float32 and bfloat16 with phase 8's bounds, and its time
   there.  ``extract_signals_landmark_roi`` with
   ``make_mediapipe_roi_detector()`` and ``extract_signals_polygon`` with
   ``make_mediapipe_poly_detector()`` on phase 8's clip: K5 launched, >= 95%
   valid after the acquisition, BPM MAE at most 0.5 against the numpy
   reference on the port's own trace; the polygon path's peak device memory
   above the clip logged and under an eighth of the clip's float32 size.
   ``rppg_video --faces 2 --detector mediapipe`` on the two-face clip as
   MJPG (K5 launched, each face within 8 BPM, x-order);
   ``LivePipeline(k_faces=2)`` with the K=2 detector and a 4-slot
   ``BpmServer(k_faces=2)`` with it (two slots mirrored) on two faces at
   720p for 600 frames and ticks (a live stream's BPM settles once its
   500-sample ring holds no start-up transient): K5 launched, every subject
   valid within 8 BPM at the end.  Each check's time is logged;
8c. the learned landmarker and the cascade detectors, at the shipped
   config (bf16, stem 48, blocks 64-384), their weights read from
   ``checkpoints/*.npz`` through the apps' detector choices.  The
   ``landmarker`` and ``refined`` detectors through ``measure_green_avg(
   use_pallas="roi")`` on phase 4's clip (1080p x 960): K2 launched and
   held bit for bit against its plain version on each measure's ROIs,
   >= 95% valid after the acquisition, BPM MAE at most 0.5 against the
   numpy reference on the port's own trace, the last valid BPM within 3 of
   72, the boxes' mean IoU with the ellipse's box >= 0.8; each detector
   alone timed.  The float32 landmarker on the card against the CPU on
   the clip's first 16 frames (landmarks within 1e-4: no TF32), bf16
   against float32 on the card logged.  The tiled ``landmarker`` and the
   ``refined`` cascade through ``measure_green_avg_multi`` on two faces at
   720p (480 frames, 60 and 96 BPM, 10 s windows): every steady frame
   valid, each face's mean BPM error within 5.  ``LivePipeline`` with the
   landmarker on one 720p subject for 600 frames: K2 launched, the last BPM
   valid within 8, the submit's p50 logged.  ``landmarker-real`` on the
   real portrait animated at 1.8x (1080 x 922, made on the host in a thread
   started after phase 2; 600 frames with 10 s windows, cut from 960
   because the host synthesis takes some 85 ms a frame) through the
   same measure and gates, IoU >= 0.75 (the JAX package's real-face bar)
   against the tracked box, and on the still portrait against the
   MediaPipe box;
9. the live pipeline: one 720p subject of the pool's population, 760
   frames, ``LiveConfig(fps=30, use_fused=True)``, through ``LivePipeline``
   on the card in four modes (BGR, I420 frames from ``bgr_to_i420_host``,
   ``fetch_every=4``, ``frames_per_call=8``): K4 once a frame in each,
   every output equal bit for bit to the sequential ``make_step`` output of
   the same transfer, the last BPM valid within 8 BPM of the truth; K4
   equal bit for bit to its plain version at that one slot, on the
   carries and phases the sequential step gives it (BGR, I420, and I420
   with the live app's ``--fused`` row pool 8 and gate 0.15), and K4's
   time there against its bound; the
   latency from submit to returned output (p50, p90) and the host-to-card
   bytes a frame of each mode; then 100 submits under ``torch.profiler``
   with ``torch.cuda.set_sync_debug_mode("warn")``, which must flag no
   synchronizing operation (a submit waits for the card only at its
   fetch, an event wait: the host waits the profiler sees are logged);
10. the serving pool at full width: ``BpmServer(LiveConfig(fps=30,
   use_fused=True), n_slots=64)`` on 720p frames made on the card, one tick
   at a time for 760 ticks.  Each slot has its own pulse rate (55-110 BPM)
   and sway phase; slots attach in a staggered order, one slot skips every
   tenth tick, one is detached and reattached.  K4 must have launched;
   every slot must end ``bpm_valid`` within 8 BPM of its rate; two slots must
   equal the single-stream fused live step on the same frames; a slot whose
   ring is full must report the ``scipy.signal.welch`` peak of its last 500
   filtered samples.  Then the same population through the skin-detector
   tick (``use_fused=False``, ROI means on K2), and through the fused tick
   with ``method="adaptive"``: K4 launched, every slot valid within 8 BPM,
   the two slots' BPM, validity and choice equal to the single step's on
   >= 99% of ticks, and every slot's last BPM, validity and choice equal to
   the port's method on the CPU from the pool's rings.  Then a fused pool
   with ``transfer="i420"`` beside a BGR one on the same 64 x 720p frames
   for 100 ticks: K4 launched in both, ``face_valid`` equal on every tick,
   ``green_raw`` within 1.5 u8; the median tick wall time of each;
11. a server that answers requests: ``serve_forever`` on a 4-slot fused 720p
   pool, two ``BpmClient``s and one ``WsBpmClient`` stream 700 frames each
   and must get one JSON line per frame, the last ``bpm_valid`` within 8 BPM
   of the truth; then 10 one-frame round trips each.  Then one
   ``BpmClient(transfer="i420")`` against a 4-slot I420 server for 700
   frames: one line per frame, the last ``bpm_valid`` within 8 BPM;
12. the apps: ``apps.rppg_livestream.main(["--video", ..., "--no-display",
   "--fused", "--transfer", "i420"])`` on the live subject written as MJPG
   must exit 0 with the median of its last 60 printed BPM within 8 BPM of
   the truth; ``apps.serve_bpm.main(["--connect", ..., "--video", ...,
   "--max-frames", "200"])`` against a served I420 pool must exit 0 and
   print ``sent 200 frames``;
13. the analysis harness through its CLI, ``analysis.main.main([...,
   "--device", "cuda"])``, into a temporary results and cache directory:
   the flagship clip's first 320 frames (10.7 s, full width, past the
   measures' 10 s acquisition; 360 before phase 16 was paid for) written
   as mp4v with a truth CSV every 0.5 s, swept over ``spatial_resolution``
   (1080p, 720p, 480p, 360p, 240p, each resize on the card) with
   ``green_avg`` and ``evm`` (K6 launched), then over ``colour_noise``
   (0-40 sigma, drawn on the card) with ``green_avg`` alone (``evm`` on
   its levels left the sweep to pay for phase 16); then the MediaPipe
   phase's drawn face, its first 320 frames too, as mp4v, ``--degradation
   original --methods green_avg
   --detector mediapipe`` (K5 launched: the detector fuses its stages on a
   CUDA card).  Each sweep exits 0 with every level's ``.npy`` of the rows
   ``summary.json`` records, finite; the control levels (1080p, 0std) hold
   green_avg's median BPM within 8 BPM of the truth, the 1080p level the
   EVM MAE within 4 BPM, and so does the face's green_avg median; the 1080p
   level's green_avg rows equal ``offline.measure_green_avg`` on the same
   decoded frames on the card; the 720p resize of a 32-frame chunk on the
   card is within 1 u8 of the CPU's.  Logs ``summary.json``'s stage times
   and each measure's frames/s over its levels;
14. the apps and the multi-face path, each entry point on the card:
   ``apps.rppg_video.main`` with ``--live-panels`` on a 1080p MJPG cut of
   the flagship clip (its first 320 frames, 10.7 s: the 10 s window
   fills; 360 before phase 16 was paid for) must exit 0, write
   ``annotated.mp4`` with 320 frames and print the
   three filters' last valid BPM within 8 BPM of the truth; ``analyze``'s
   green trace and validity equal ``offline.extract_signals`` on the same
   decoded frames, and ``live_panel_data``'s panel BPM medians are within
   8 BPM; ``apps.bpp.main(["--json"])`` on that file counts its frames and
   gives entropy, noise variance and NSR within ``rtol=1e-5`` of numpy on
   cv2's ``COLOR_BGR2GRAY`` frames; the video app with ``--detector
   mediapipe`` on the MediaPipe phase's drawn face cut to 320 frames (K5
   launched, the same 8 BPM gate); ``--faces 2`` on a two-face 720p clip
   made on the card from a seed (60 and 96 BPM, 480 frames): each face
   within 8 BPM of its rate and the boxes in x-order.
   ``LivePipeline(k_faces=2)`` on 600 frames of those subjects equals the
   sequential ``make_step_multi`` bit for bit, each subject's last BPM
   valid within 8 BPM, and 100 submits under sync debugging flag no
   synchronizing operation; ``BpmServer(k_faces=2, use_fused=False)`` with
   4 slots (two of them mirrored: face0 the 96 BPM subject) for 700 ticks:
   every subject valid within 8 BPM at the end, slot 0 equal to
   ``step_multi`` on its own frames on every tick.
   ``apps.evm_magnify.main`` on a 1080p 300-frame MJPG clip with a 55 BPM
   pulse (one chunk of its 20 s; 600 frames before phase 16 was paid
   for): K6 and K7 launched once each, the mp4v output
   decodes to the input's shape, the cheek's green pulse amplified more
   than 5x.  ``validation.main`` in a temporary directory exits 0 and
   writes ``VALIDATION_TORCH.md`` there, and nothing else; ``entry()``
   launches K1 once and its forward equals ``measure_green_avg(
   use_pallas="fused")`` on the same frames, and K1 equals its plain
   version on that clip.  Each check's time is logged;
14b. multi-device, each path on a mesh of 4 places of the card (one
   process, the shards one after another): the stream farm at BASELINE's
   64 concurrent 720p streams, T=32 at 30 fps, 1 s windows, made on the
   card from a seed, ``multistream_green_bpm`` in the skin form
   (``downsample=4``, K2 once a shard) and the fused form (row pool 8, gate
   0.15, K1 once a shard with ``seq_len=32``): >= 95 % of the frames from
   the end of the acquisition valid, validity and the green trace equal
   to the same call on a 1-place mesh, BPM within 1e-4, frames/s logged;
   the MediaPipe farm, 64 x 8 frames of the real portrait at 720p (10 fps,
   0.8 s windows), K5 in each shard: every stream valid after the
   acquisition, BPM in the band; the time-sharded long measure
   (``measure_green_avg_sharded``) on a 720p clip of 3,600 frames (2 min:
   an hour cut to the time limit) with ``PipelineConfig()``, so a shard's
   900 frames are one window: validity equal to ``measure_green_avg`` on
   the same frames, BPM within ``rtol=1e-5, atol=1e-4``, with the
   band-pass the median BPM within 3 of the truth, the peak memory above
   the clip logged; the fused (K4) and skin (K2) pools with their 64 slots
   over the places, for the first 120 ticks of phase 10's schedule and
   population: every tick's outputs equal to phase 10's unsharded pool,
   one launch a place a tick.  K1, K2, K4 and K5 are each held against
   their plain versions on one shard's own input.  Two worker processes
   (``python -m vhr_tpu_torch.parallel.farm_worker``) on the card, joined
   on gloo, 4 places each, run in the background from the phase's start:
   the stream farm over the 8 places and an SPMD pool of 8 slots for 150
   ticks; each must exit 0 within 120 s, both with the same gathered
   results, host 0's frames on host 1, every slot within 10 BPM;
16. training (run right after phase 8c, while the flagship clip is on the
   card): ``models.train.main`` at full width (``TrainConfig()``: the
   48/(64, 128, 256, 384) landmarker at 96 x 96 in bf16, batch 64, the hard
   generator) from the port's own initialisation for 150 steps: every
   loss finite and the mean of the last 20 below 0.8 of the first 20's
   (``train.main`` on the CPU with the same seed reached 0.5889, 0.7164
   at 100 steps); steps/s and
   samples/s, the card's step time by CUDA events against the host's
   batch draw, the card's busy share over 20 steps under
   ``torch.profiler`` and the peak memory logged.  The trainer's batches
   are its own draws from its seed, made by a worker process started
   after phase 2 (host-only work beside the card's) and replayed through
   its batch source; the first of each run is drawn again and must be
   equal.  Then the JAX package's fine-tune recipe, ``--resume
   checkpoints/landmarker.npz --real-frac 0.25 --lr 1e-4`` for 30 steps
   into a temporary directory: ``evaluate_iou`` on 12 clips of each
   family before and after, the held-out IoU after at least 0.8 (the JAX
   package's bar), the checkpoint reloaded by ``landmarker.load_params``
   bit for bit.  The reloaded weights as the ``landmarker`` detector
   through ``measure_green_avg(use_pallas="roi")`` on the flagship clip
   with phase 8c's gates (K2 launched and held bit for bit against its
   plain version on the measure's ROIs, >= 95% valid, BPM MAE at most 0.5
   against the numpy reference, the last valid BPM within 3 of 72, IoU at
   least 0.8).  The dp×tp step on a (2, 2) mesh of 4 places of the card at
   full width and batch 64 against the unsharded step from the same params
   and batch: float32 loss within 1e-5 relative and params within 1e-6 on
   >= 99.9% of elements (the rest within AdamW's sign flip, 2 lr), bf16
   loss within 1e-2.  Then ``entry.dryrun_multichip(4)``, its step 1 the
   dp×tp step with a finite loss.  The phase's checks and times are logged;
15. launch K4 twice more on the fused pool's last frames and state, which
   must give the same bits both times (each launch leaves its accumulators
   clean), and time each pool tick (device time, and wall time with the
   host-to-card upload and the fetch) and each kernel against its plain
   version, with
   CUDA events (median of 3 after a warm-up; K4 with the card kept busy
   while the host enqueues its calls, also with row pooling and with
   gating, and the kernels ``torch.profiler`` sees in 20 calls of
   each, which must be one a call); both offline forms are timed
   right after phase 4, the fused one again at the end, and the EVM path
   right after phase 7; K1 also on one 256-frame chunk, as the streams
   launch it.

The launch counters are set to 0 just before each of the main paths (the
offline measure, each call of the other measures, each stream and the
file measure, ``magnify``, the EVM measure, the MediaPipe measure, each
path of phase 8b, each single-face path of phase 8c, phase 16's measure,
each mode of the live pipeline, the fused pool, the skin pool, the adaptive
pool, the I420 pool pair, the servers, the live app, each analysis
sweep, each path of phase 14 and of phase 14b) and read just after; K2's and K3's vectorised instance must have taken
every launch of the offline run, the detect stream, the MediaPipe measure
and the skin pool.  The record's launches: K1's in the offline run, the
other measures' fused calls, the 4-decoder stream and the fused I420
stream, K2's in the offline run, the other measures' ``"roi"`` calls, the
MediaPipe measure, phase 8c's four single-face paths (the ``landmarker``,
``refined`` and ``landmarker-real`` measures, the live pipeline with the
landmarker), phase 16's fine-tuned ``landmarker`` measure, the skin pool,
and phase 14b's skin farm, long measures and
sharded skin pool, K3's in the detect stream, K4's in the
fused and the adaptive pool, the live pipeline's four modes, the I420
pool pair and the sharded fused pool, K5's in the MediaPipe measure and
farm, phase 8b's six paths (the
K=2 measure, the pose-robust and polygon measures, the video app with
``--faces 2``, the live pipeline and the pool with the K=2 detector), the
MediaPipe sweep and the video app's ``--detector mediapipe``, K6's in ``magnify``, the EVM
measure, the degradation sweep and ``evm_magnify``, K7's in ``magnify``
and ``evm_magnify``; K1's also ``entry()``'s and the fused farm's.  K2's time is at 1080p x 960, and its time
at the skin pool's 64 x 720p slots and K3's on a 256-frame chunk are
logged with their bounds.
The line before the last is the kernels' JSON record: per kernel (K1 to
K7, then the ramp's, which replaces no TPU kernel) its time
and its plain version's, and ``bound_ms``, the least time the card could
take for the same work: the larger of the bytes it must move (inputs read
once, outputs written once; for the ROI kernels the ROI bytes of this run's
boxes) over 3.35 TB/s and its operations over 67 TFLOP/s (float32 on the
CUDA cores; K5's two 1x1 convs, which run on the tensor cores in three TF32
passes, count once over 495 TFLOP/s, which leaves K5 bound by its bytes).
Every kernel's time, like K4's, is taken with the card's queue filled
ahead (K1, K2, K3, K6 and K7 also paced by the host, in the log, with
K1's two launches under the profiler).  No single PyTorch call computes
any of these functions, so ``library_ms`` is null (a K5 stage is 25
ops; their unfused time is logged beside it).  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card the script exits
non-zero before printing any result; it imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

SEED = 0
FPS = 30.0
T, H, W = 960, 1080, 1920
TRUTH_BPM = 72.0
MEANS_RTOL, MEANS_ATOL = 1e-6, 1e-5
# The serving pool: 64 slots of 720p.  A stream's causal band-pass starts
# from a zero state, and its start-up transient spans its first ~100
# samples at 30 fps; the Welch estimate over the 500-sample ring finds the
# pulse once the ring holds no transient.  So every client streams more
# than 600 frames: 760 ticks for the pool, 700 frames for each client of
# the server.
SLOTS, PH, PW, TICKS = 64, 720, 1280, 760
SERVE_FRAMES, SERVE_RTT = 700, 10
BPM_TOL = 8.0          # the JAX package's serving tests' bound
# The EVM path: magnify runs on the app's 20 s chunk with a pulse inside
# EVMConfig's default band (0.83-1.0 Hz); kernels and routes are compared
# on the first 64 frames.
EVM_T, EVM_BPM, EVM_CHECK_T = 600, 55.0, 64
K6_ATOL, K7_MAX_FRAC = 1e-6, 1e-3
EVM_MAE_TOL = 4.0      # tests/test_evm.py's bound
# Streaming ingest: the flagship clip's first 448 frames (cut from 960 for
# the script's time, to 704 and then 448: every pass of the phase decodes
# the whole file on the host) in chunks of 256 (the last one 192), past
# the 10 s acquisition; the multi-decoder stream with
# 4 cv2 decoders, and an mp4v copy of the clip's
# first 240 frames (an inter-frame codec, whose seeks the decoders rely on)
# read in chunks of 32.
STREAM_T, STREAM_CHUNK = 448, 256
DECODERS, MP4V_T, MP4V_CHUNK = 4, 240, 32
I420_TOL = 1.5         # u8: plane means against reconstruct-then-reduce
# The analysis harness: its degradation sweeps run on the flagship clip's
# first ANALYSIS_T frames (10.7 s at full width, past the measures' 10 s
# acquisition; cut from 360 to pay for phase 16: the whole clip's sweep of
# 10 levels took 304 s on an H100 host, nearly all of it cv2's mp4v encode
# and decode on the host), and so does its MediaPipe sweep on the drawn
# face (the whole 960-frame clip took 32 s to write and measure there);
# the resize on the card is held against the CPU on one chunk of
# ANALYSIS_RESIZE_T frames of the 720p level.
ANALYSIS_T, ANALYSIS_RESIZE_T = 320, 32
# The live pipeline: one 720p subject, 760 frames, four modes; the
# profiled window of submits after a warm-up.
LIVE_FRAMES, LIVE_WARM, LIVE_PROFILED = 760, 40, 100
# The I420 pool beside the BGR pool: 64 x 720p for 100 ticks.
I420_TICKS = 100
# The served pool's client in client mode: 200 frames of the subject.
APP_CLIENT_FRAMES = 200
# The apps and multi-face phase: the video app on APP_T frames (10.7 s:
# its 10 s window fills) at 1080p; two faces at 720p with their own rates,
# the video app on the first DUO_APP_T frames, LivePipeline on DUO_LIVE_T,
# a pool of DUO_SLOTS slots for DUO_POOL_T ticks; evm_magnify on MAG_APP_T
# frames (10 s of one 20 s chunk).  APP_T was 360 and MAG_APP_T 600 before
# phase 16 was paid for.
APP_T, MAG_APP_T = 320, 300
DUO_BPM = (60.0, 96.0)
DUO_APP_T, DUO_LIVE_T, DUO_POOL_T, DUO_SLOTS = 480, 600, 700, 4
# The MediaPipe phase: tests/test_mediapipe_face.py's schematic face drawn
# 4.2x its size at 1080p (BlazeFace scores it ~0.87 there), swaying 3 px.
MP_SCALE, MP_SWAY = 4.2, 3
K5_F32_TOL = 1e-5      # of max|y|: the same sums in another order
EXEC_TOL = {"face_detector.tflite": 2e-5,            # the JAX package's
            "face_landmarks_detector.tflite": 3e-4}   # oracle bounds
# Fused against unfused landmarks: the JAX package's bf16 bound, 1.5 px RMS
# (tests/test_mediapipe_face.py:341-342), holds for its 256x320 face.  The
# mesh net's error lives in its 256-px crop and is scaled by the ROI side
# when it is projected, so the bound is applied in crop pixels: 1.5 * 256 /
# the ROI side the detector finds on that face, whatever the face's size.
MP_RMS_PX = 1.5
MP_IOU_MIN = 0.5
MP_SINGLE_N = 8        # frames the product detector sees one a call
# The multi-face and landmark-ROI phase: two of the MediaPipe phase's faces
# side by side at 1080p for the K=2 measure and the video app (MPM_T
# frames, 12 s: the app's 10 s window fills), and at 720p for the live
# pipeline and the pool (MPM_LIVE_T frames: a live stream's BPM settles
# once its 500-sample ring holds no start-up transient of the filter).
MPM_T, MPM_LIVE_T = 360, 600
# The learned-detector phase: the landmarker and the refined detector on
# the flagship clip (IoU with the skin ellipse's box, the last valid BPM
# within LEARNED_BPM_TOL); landmarker-real on the real portrait animated at
# REAL_SCALE (1080 x 922) for REAL_T frames with 10 s windows (its host
# synthesis takes some 85 ms a frame, so the clip is cut from 960 frames),
# JAX's real-face IoU bar; the two-face 720p clip, each face's steady mean
# BPM error within DUO_LEARNED_TOL; LivePipeline on LEARNED_LIVE_T frames;
# the float32 landmarks on the card within LANDMARK_F32_TOL of the CPU's.
# The multi-device phase (14b): bench.py's on-chip farm shapes, 64 streams
# of 720p over FARM_PLACES places of the card (T=FARM_T at 30 fps; the
# MediaPipe farm MP_FARM_T frames at MP_FARM_FPS), a LONG_T-frame 720p
# recording (2 min: an hour cut to the time limit) over the same places,
# the serving pools' first POOL_MESH_TICKS ticks over them, and two farm
# worker processes, each given FARM_WORKER_TIMEOUT seconds.
FARM_S, FARM_T, FARM_PLACES = 64, 32, 4
MP_FARM_T, MP_FARM_FPS = 8, 10.0
LONG_T, POOL_MESH_TICKS, FARM_WORKER_TIMEOUT = 3600, 120, 120.0
LEARNED_IOU_MIN, LEARNED_BPM_TOL = 0.8, 3.0
REAL_T, REAL_SCALE, REAL_IOU_MIN = 600, 1.8, 0.75
DUO_LEARNED_TOL, LEARNED_LIVE_T, LANDMARK_F32_TOL = 5.0, 600, 1e-4
# The training phase (16): the trainer at full width (TrainConfig(): bf16,
# stem 48, blocks 64-384, 96 x 96, batch 64, the hard generator) from the
# port's own initialisation for TRAIN_STEPS steps; ``train.main`` on the
# CPU with the same seed took the mean of the last 20 losses to 0.5889 of
# the first 20's (0.7164 at 100 steps), so the gate is the 0.8 of
# TRAIN_FALL; the card's busy share over TRAIN_PROFILED steps.  The JAX
# package's fine-tune recipe for FT_STEPS steps, its IoU on FT_EVAL_CLIPS
# clips of each family, held-out at least FT_IOU_MIN.  The dp×tp step on a (2, 2)
# mesh of places: float32 loss within TP_F32_TOL relative, bf16 loss
# within TP_BF16_TOL; in both the params within TP_PARAM_TOL on >= 99.9%
# of elements and the rest within 2 lr.
TRAIN_STEPS, TRAIN_FALL, TRAIN_PROFILED = 150, 0.8, 20
FT_STEPS, FT_EVAL_CLIPS, FT_IOU_MIN = 30, 12, 0.8
TP_F32_TOL, TP_PARAM_TOL, TP_BF16_TOL = 1e-5, 1e-6, 1e-2
# The acquisition ramp's kernel (csrc/ramp_dft.cu) at the skin cell's
# shapes: RAMP_S recordings of T frames, PipelineConfig's windows.  Its bpm
# equals the plain version's but where the plain version's top two in-band
# magnitudes lie within RAMP_TIE_RTOL of each other (the sums run in
# another order); valid equals it.
RAMP_S, RAMP_TIE_RTOL = 8, 1e-5
# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM
# bytes/s, float32 operations/s on the CUDA cores, and dense TF32
# operations/s on the tensor cores.
HBM_BPS, F32_OPS, TF32_OPS = 3.35e12, 67e12, 495e12


def log(msg: str) -> None:
    print(msg, flush=True)


def counter(name: str) -> int:
    """A launch counter of the port's registry (``k1.launches``, ...)."""
    from vhr_tpu_torch.utils import profiling

    return profiling.counter(name)


def reset_counters(*names: str) -> None:
    from vhr_tpu_torch.utils import profiling

    profiling.reset_counters(*names)


def make_clip(device, t: int, h: int, w: int, seed: int = SEED,
              chunk: int = 64, bpm: float = TRUTH_BPM):
    """``(t, h, w, 3)`` u8 BGR face clip made on ``device`` from a seed,
    with a ``bpm`` green pulse, and its ``(t, 4)`` int32 ground-truth face
    boxes (inclusive ends)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    frames = torch.empty((t, h, w, 3), dtype=torch.uint8, device=device)
    boxes = torch.empty((t, 4), dtype=torch.int32, device=device)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    rx, ry, cy = 0.16 * w, 0.26 * h, 0.45 * h
    bg = torch.tensor([60.0, 60.0, 60.0], device=device)
    skin = torch.tensor([105.0, 135.0, 180.0], device=device)
    for s in range(0, t, chunk):
        n = min(chunk, t - s)
        ts = torch.arange(s, s + n, device=device, dtype=torch.float32) / FPS
        cx = 0.5 * w + 4.0 * torch.sin(2 * math.pi * 0.1 * ts)   # sway, px
        pulse = 2.0 * torch.sin(2 * math.pi * bpm / 60.0 * ts)
        face = (((xx - cx[:, None, None]) / rx) ** 2
                + ((yy - cy) / ry) ** 2) <= 1.0                    # (n, h, w)
        color = skin.expand(n, 3).clone()
        color[:, 1] += pulse
        img = torch.where(face[..., None], color[:, None, None, :], bg)
        img += torch.randint(0, 8, (n, h, w, 3), generator=gen,
                             device=device).to(torch.float32)
        frames[s:s + n] = img.clamp(0, 255).to(torch.uint8)
        col_any, row_any = face.any(1), face.any(2)
        ci = torch.arange(w, device=device).expand(n, w)
        ri = torch.arange(h, device=device).expand(n, h)
        boxes[s:s + n] = torch.stack([
            torch.where(col_any, ci, w).amin(1),
            torch.where(row_any, ri, h).amin(1),
            torch.where(col_any, ci, -1).amax(1),
            torch.where(row_any, ri, -1).amax(1)], -1).to(torch.int32)
    return frames, boxes


class Subjects:
    """Live subjects, each with its own pulse rate and sway phase: frame k
    of subject i (``frames(idx, k)``) is made on the card from a seed."""

    def __init__(self, device, n: int, h: int, w: int, seed: int):
        import torch

        self.device, self.h, self.w = device, h, w
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.bpm = 55.0 + 55.0 * torch.rand(n, generator=self.gen,
                                            device=device)
        self.sway = 2 * math.pi * torch.rand(n, generator=self.gen,
                                             device=device)
        self.yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
        self.xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]

    def frames(self, idx, k):
        """``(len(idx), h, w, 3)`` u8: subject ``idx[j]``'s frame ``k[j]``."""
        import torch

        idx = torch.as_tensor(list(idx), device=self.device)
        ts = torch.as_tensor(k, device=self.device,
                             dtype=torch.float32) / FPS
        n = idx.shape[0]
        cx = 0.5 * self.w + 4.0 * torch.sin(2 * math.pi * 0.1 * ts
                                            + self.sway[idx])
        face = (((self.xx - cx[:, None, None]) / (0.16 * self.w)) ** 2
                + ((self.yy - 0.45 * self.h) / (0.26 * self.h)) ** 2) <= 1.0
        color = torch.tensor([105.0, 135.0, 180.0],
                             device=self.device).expand(n, 3).clone()
        color[:, 1] += 2.0 * torch.sin(2 * math.pi * self.bpm[idx] / 60.0
                                       * ts)
        img = torch.where(face[..., None], color[:, None, None, :],
                          torch.tensor([60.0, 60.0, 60.0],
                                       device=self.device))
        img += torch.randint(0, 8, img.shape, generator=self.gen,
                             device=self.device).to(torch.float32)
        return img.clamp(0, 255).to(torch.uint8)


def compare(name: str, got, want) -> float:
    """Equal integer/bool fields, means within tolerance; max |err|."""
    import torch

    err = 0.0
    for g, w_ in zip(got, want):
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w_, rtol=MEANS_RTOL,
                                       atol=MEANS_ATOL, msg=name)
            err = max(err, float((g - w_).abs().max()))
        elif not torch.equal(g, w_):
            bad = (g != w_).nonzero()[:5].tolist()
            raise AssertionError(f"{name}: integer outputs differ at {bad}")
    return err


def cuda_ms(fn, reps: int = 3, inner: int = 1,
            queue_ahead: bool = False) -> float:
    """Median milliseconds per call over ``reps`` timed runs of ``inner``
    calls each, after one warm-up call, from CUDA events.

    With ``queue_ahead`` the card first spins for some 10 ms while the host
    enqueues the calls, so that the events time the card alone even where
    the host takes longer to enqueue a call than the card to run it."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queue_ahead:
            torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def wall_ms(fn, reps: int = 3, inner: int = 1) -> float:
    """Median host milliseconds per call (each run ends synchronized)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / inner)
    return statistics.median(times)


def device_profile(fn, top: int = 8):
    """One call of ``fn`` under ``torch.profiler``, tracing the card's
    activity alone: (milliseconds the card was busy, the union of its
    kernel, copy and set intervals; the ``top`` kernels by device time as
    ``(name, ms, calls)``).  ``(None, [])`` when the profiler traced no
    device work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, per_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (ms + (e.time_range.end - e.time_range.start)
                            / 1e3, n + 1)
    if not spans:
        return None, []
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    return busy / 1e3, [(k, ms, n) for k, (ms, n) in ranked]


def bound(nbytes: float, ops: float, tensor_ops: float = 0.0):
    """(least milliseconds for the work on the card, what bounds it):
    ``tensor_ops`` of the ``ops`` run on the tensor cores in TF32, the rest
    in float32 on the CUDA cores."""
    t_bytes = nbytes / HBM_BPS
    t_ops = max((ops - tensor_ops) / F32_OPS, tensor_ops / TF32_OPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def roi_bytes(rois, h: int, w: int, c: int = 3) -> int:
    """The pixel bytes the ROIs cover inside an ``h x w`` frame."""
    x1, y1 = rois[:, 0].clamp(0, w), rois[:, 1].clamp(0, h)
    x2, y2 = rois[:, 2].clamp(0, w), rois[:, 3].clamp(0, h)
    area = (x2 - x1).clamp(min=0).long() * (y2 - y1).clamp(min=0).long()
    return int(area.sum()) * c


def ramp_traces(dev, s: int, seed: int = SEED):
    """``(T, s)`` float32 green traces on ``dev``: 50-170 BPM pulses on a
    level of 100 with noise, seeded."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None] / FPS
    x = (np.sin(2 * np.pi * rng.uniform(50.0, 170.0, s) / 60.0 * t)
         + 0.8 * rng.normal(size=(T, s)) + 100.0)
    return torch.as_tensor(x.astype(np.float32), device=dev)


def ramp_pairs(fps: float, band, n_first: int, n_last: int) -> int:
    """The in-band ``(k, n)`` pairs of the ramp's lengths: the angles the
    kernel evaluates, each multiplied into every stream twice."""
    import numpy as np

    k_max = int(np.floor(band.high_hz * n_last / fps))
    N = np.arange(n_first, n_last + 1, dtype=np.float32)[:, None]
    k = np.arange(k_max + 1, dtype=np.float32)[None]
    freq = k * (np.float32(fps) / N)
    mask = ((freq >= np.float32(band.low_hz))
            & (freq <= np.float32(band.high_hz)) & (k >= 1)
            & (k <= np.floor((N - 1) / 2)))
    return int((mask.sum(1) * N[:, 0]).sum())


def check_ramp(dev, cfg) -> dict:
    """The ramp kernel against its plain version at the skin cell's shapes,
    one launch: valid equal, bpm equal but at the plain version's near
    ties.  Returns the traces, the lengths and the largest bpm gap."""
    import torch
    from vhr_tpu_torch.ops import windows as vwin

    x = ramp_traces(dev, RAMP_S)
    n_first, n_last = cfg.acquisition_len(FPS), cfg.window_len(FPS)
    before = counter("ramp.launches")
    bpm, valid = vwin.ramp_bpm(x, FPS, cfg.band, n_first, n_last)
    if counter("ramp.launches") != before + 1:
        raise AssertionError("the ramp took another route than one launch")
    want_bpm, want_valid = vwin._ramp_bpm(x, FPS, cfg.band, n_first, n_last)
    torch.cuda.synchronize()
    if not torch.equal(valid, want_valid):
        raise AssertionError("ramp kernel: valid differs from plain")
    differ = bpm != want_bpm
    if differ.any():
        ties = vwin._ramp_near_ties(x, FPS, cfg.band, n_first, n_last,
                                    RAMP_TIE_RTOL)
        if not bool(ties[differ].all()):
            raise AssertionError("ramp kernel: bpm differs from plain away "
                                 "from a near tie")
    err = float((bpm - want_bpm).abs().max())
    log(f"[check] ramp kernel == plain at {T} x {RAMP_S} traces, lengths "
        f"{n_first}..{n_last}: valid equal ({int(valid.sum())} valid), bpm "
        f"equal on {int((~differ).sum())} of {differ.numel()}, the rest at "
        f"near ties (largest gap {err:g} BPM)")
    return {"x": x, "n_first": n_first, "n_last": n_last, "err": err}


def u8_diff(got, want):
    """(max |got - want|, share of differing values) of two u8 tensors."""
    import torch

    d = (got.to(torch.int16) - want.to(torch.int16)).abs()
    return int(d.max()), float((d > 0).double().mean())


def evm_band(low, cfg):
    """The amplified band ``magnify`` gives K7, ``(T, 3, hb, wb)``, from
    K6's output ``low``."""
    import torch
    from vhr_tpu_torch.pipeline import evm

    a = cfg.amplification
    gains = torch.tensor([a, a * cfg.attenuate_chroma,
                          a * cfg.attenuate_chroma], device=low.device)
    low = evm.gaussian_pyramid_level(low.permute(0, 2, 3, 1),
                                     cfg.pyramid_levels - 1)
    band = evm.temporal_ideal_bandpass(low, FPS, cfg.band) * gains
    return band.permute(0, 3, 1, 2).contiguous()


def check_evm_kernels(dev, frames) -> dict:
    """K6 and K7 against their plain versions on the clip's first
    EVM_CHECK_T frames at full size, on a 720p slice and at a width of 1000;
    K7 on the pipeline's band and on a random band of +-0.5, read and
    written interleaved (the EVM path's layout) and planar; where the
    interleaved frames take K7's vectorised instance (1080p, 720p), it must
    equal the generic instance bit for bit."""
    import torch
    from vhr_tpu_torch.config import EVMConfig
    from vhr_tpu_torch.ops import evm_cuda, evm_recon_cuda

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    n = EVM_CHECK_T
    # K6 copies rows in 16-byte chunks at 1080p and 720p, in 4-byte chunks
    # at a width of 1000 and a byte at a time at the odd width.
    clips = {f"{W}x{H}": frames[:n], "1280x720": frames[:n, :720, :1280],
             f"1000x{H}": frames[:n, :, :1000],
             f"{W - 3}x{H - 1}": frames[:n, :H - 1, :W - 3]}
    k6_err, k7_err = 0.0, 0
    for name, x in clips.items():
        x = x.contiguous()
        got = evm_cuda.yiq_pyrdown(x)
        want = evm_cuda.yiq_pyrdown_plain(x)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if got.shape != want.shape or err > K6_ATOL:
            raise AssertionError(f"K6 {name}: max |err| {err}")
        k6_err = max(k6_err, err)
        log(f"[check] K6 == plain at {name} x {n}: max |err| {err:.3g}")
        if name.startswith(f"{W - 3}x"):
            continue
        band = evm_band(got, EVMConfig())
        rand = torch.rand(band.shape, generator=gen, device=dev) - 0.5
        for bname, b in (("pipeline", band), ("random +-0.5", rand)):
            for layout in ("interleaved", "planar"):
                planar = evm_cuda.to_planar(x)
                if layout == "planar":
                    planar = planar.contiguous()
                vec = counter("k7.vec")
                g = evm_recon_cuda.evm_reconstruct(planar, b)
                vec = counter("k7.vec") > vec
                w_ = evm_recon_cuda.evm_reconstruct_plain(planar, b)
                torch.cuda.synchronize()
                mx, frac = u8_diff(g, w_)
                if mx > 1 or frac > K7_MAX_FRAC:
                    raise AssertionError(f"K7 {name} {bname} {layout}: max "
                                         f"|diff| {mx}, share {frac}")
                k7_err = max(k7_err, mx)
                log(f"[check] K7 ({'vectorised' if vec else 'generic'}) == "
                    f"plain at {name} x {n}, {bname} band "
                    f"{tuple(b.shape[2:])}, {layout}: max |diff| {mx} u8 "
                    f"on {frac:.3g} of the values")
                if layout == "interleaved" and name != f"1000x{H}":
                    if not vec:
                        raise AssertionError(f"K7 {name}: the vectorised "
                                             f"instance was not taken")
                    same_bits(f"K7 {name} {bname} vectorised vs generic",
                              (g,), (evm_recon_cuda.evm_reconstruct(
                                  planar, b, instance="generic"),))
                    log(f"[check] K7 vectorised == generic bit for bit at "
                        f"{name} x {n}, {bname} band")
    return dict(k6_err=k6_err, k7_err=float(k7_err))


def cheek_pulse(x, bpm: float) -> float:
    """Spectral amplitude at ``bpm`` of the mean green of a cheek patch of
    ``(t, H, W, 3)`` u8 frames of ``make_clip``'s face."""
    import torch

    h, w = x.shape[1], x.shape[2]
    g = x[:, int(0.50 * h):int(0.58 * h), int(0.38 * w):int(0.45 * w), 1]
    g = g.double().mean((1, 2))
    spec = torch.fft.rfft(g - g.mean()).abs()
    freqs = torch.fft.rfftfreq(g.shape[0], 1.0 / FPS)
    return float(spec[torch.argmin((freqs - bpm / 60.0).abs())])


def run_evm(dev, frames) -> dict:
    """``magnify`` on a T=EVM_T 1080p clip with a 55 BPM pulse, then the EVM
    measure on the flagship clip ``frames``; counters from 0 before each,
    read after.  Checks, then times the path."""
    import numpy as np
    import torch
    from vhr_tpu_torch.analysis.measurement import evm as measure_evm
    from vhr_tpu_torch.config import EVMConfig, HRBand
    from vhr_tpu_torch.ops import evm_cuda, evm_recon_cuda
    from vhr_tpu_torch.pipeline import evm

    cfg = EVMConfig()
    clip, _ = make_clip(dev, EVM_T, H, W, seed=SEED + 6, bpm=EVM_BPM)
    reset_counters("k6.launches", "k7.launches")
    reset_counters("k7.vec", "k7.generic")
    out = evm.magnify(clip, FPS, cfg, use_pallas=True)
    torch.cuda.synchronize()
    launches = {"K6": counter("k6.launches"), "K7": counter("k7.launches"),
                "K7 vectorised": counter("k7.vec")}
    log(f"[evm] kernel launches in magnify: {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of magnify never launched: "
                             f"{launches}")
    if launches["K7 vectorised"] != launches["K7"]:
        raise AssertionError("magnify launched K7's generic instance")
    if out.dtype != torch.uint8 or out.shape != clip.shape:
        raise AssertionError(f"magnify gave {out.dtype} {tuple(out.shape)}")
    amp_in, amp_out = cheek_pulse(clip, EVM_BPM), cheek_pulse(out, EVM_BPM)
    log(f"[evm] magnify {tuple(clip.shape)}: cheek green at {EVM_BPM:g} BPM "
        f"{amp_in:.1f} in, {amp_out:.1f} out ({amp_out / amp_in:.1f}x)")
    if not amp_out > 5.0 * amp_in:
        raise AssertionError(f"magnify: pulse {amp_in} -> {amp_out}")
    del out
    part = clip[:EVM_CHECK_T]
    mx, frac = u8_diff(evm.magnify(part, FPS, cfg, use_pallas=True),
                       evm.magnify(part, FPS, cfg))
    log(f"[evm] magnify kernel route vs plain route at T={EVM_CHECK_T}: "
        f"max |diff| {mx} u8 on {frac:.3g} of the values")
    if mx > 2:
        raise AssertionError(f"magnify routes differ by {mx} u8")

    reset_counters("k6.launches")
    res = measure_evm._measure_frames(frames, FPS)
    torch.cuda.synchronize()
    k6 = launches["K6 measure"] = counter("k6.launches")
    log(f"[evm] kernel launches in the EVM measure: K6={k6}")
    if k6 < 1:
        raise AssertionError("K6 never launched in the EVM measure")
    expect = T - int(measure_evm.ACQUISITION_TIME * FPS) + 1
    bpm = res[:, 1]
    mae = float(np.abs(bpm - TRUTH_BPM).mean()) if len(bpm) else math.inf
    log(f"[evm] EVM measure {tuple(frames.shape)}: {len(bpm)}/{expect} "
        f"post-acquisition frames valid; BPM MAE vs {TRUTH_BPM:g} truth "
        f"{mae:.4f}")
    if len(bpm) < 0.95 * expect or not np.isfinite(bpm).all() \
            or mae > EVM_MAE_TOL:
        raise AssertionError(f"EVM measure: {len(bpm)} valid of {expect}, "
                             f"MAE {mae}")
    band = HRBand(0.65, 3.4)
    part = frames[:EVM_CHECK_T]
    got = evm.magnified_pulse(part, FPS, band, measure_evm.LEVELS,
                              use_pallas=True)
    want = evm.magnified_pulse(part, FPS, band, measure_evm.LEVELS)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-6,
                               msg="magnified_pulse routes")
    log(f"[evm] magnified_pulse kernel route vs plain route at "
        f"T={EVM_CHECK_T}: max |diff| {float((got - want).abs().max()):.3g}")

    # Timing, frames resident on the card.
    x = frames[:EVM_CHECK_T]
    band = evm_band(evm_cuda.yiq_pyrdown(x), cfg)
    planar = evm_cuda.to_planar(x)
    n = x.shape[0]
    frame_bytes = H * W * 3
    times = {
        "K6": (cuda_ms(lambda: evm_cuda.yiq_pyrdown(x), reps=5, inner=10,
                       queue_ahead=True),
               cuda_ms(lambda: evm_cuda.yiq_pyrdown_plain(x)),
               n * 2 * frame_bytes),
        "K7": (cuda_ms(lambda: evm_recon_cuda.evm_reconstruct(planar, band),
                       reps=5, inner=10, queue_ahead=True),
               cuda_ms(lambda: evm_recon_cuda.evm_reconstruct_plain(planar,
                                                                    band)),
               n * 2 * frame_bytes + band.numel() * 4)}
    k6_paced = cuda_ms(lambda: evm_cuda.yiq_pyrdown(x), inner=10)
    k7_paced = cuda_ms(lambda: evm_recon_cuda.evm_reconstruct(planar, band),
                       inner=10)
    for k, (a, b, nbytes) in times.items():
        log(f"[time] {k} at {W}x{H} x {n}: kernel {a:.3f} ms "
            f"({a * 1e3 / n:.3f} us/frame, {nbytes / a / 1e6:.1f} GB/s), "
            f"plain {b:.3f} ms ({b * 1e3 / n:.3f} us/frame, "
            f"{nbytes / b / 1e6:.1f} GB/s)")
    k6_bound = bound(times["K6"][2], 170 * n * (H // 2) * (W // 2))[0]
    log(f"[time] K6 at {W}x{H} x {n}: {times['K6'][0]:.4f} ms with the queue "
        f"filled ahead ({times['K6'][2] / times['K6'][0] / 1e6:.1f} GB/s, "
        f"{k6_bound / times['K6'][0]:.3f} of the {k6_bound:.4f} ms bound), "
        f"{k6_paced:.4f} ms paced by the host")
    k7_bound = bound(times["K7"][2], 70 * n * H * W)[0]
    log(f"[time] K7 at {W}x{H} x {n}: {times['K7'][0]:.4f} ms with the "
        f"queue filled ahead ({times['K7'][2] / times['K7'][0] / 1e6:.1f} GB/s, "
        f"{k7_bound / times['K7'][0]:.3f} of the {k7_bound:.4f} ms bound), "
        f"{k7_paced:.4f} ms paced by the host")
    mag = {"kernel T=64": cuda_ms(lambda: evm.magnify(part, FPS, cfg,
                                                      use_pallas=True)),
           "plain T=64": cuda_ms(lambda: evm.magnify(part, FPS, cfg)),
           f"kernel T={EVM_T}": cuda_ms(lambda: evm.magnify(
               clip, FPS, cfg, use_pallas=True))}
    for route, t_ms in mag.items():
        nf = EVM_T if route.endswith(str(EVM_T)) else EVM_CHECK_T
        log(f"[time] magnify {route} route: {t_ms:.3f} ms = "
            f"{nf / (t_ms / 1e3):.1f} frames/s")
    m_ms = cuda_ms(lambda: measure_evm._measure_frames(frames, FPS))
    log(f"[time] EVM measure at {W}x{H} x {T}: {m_ms:.3f} ms = "
        f"{T / (m_ms / 1e3):.1f} frames/s")
    # K6 and K7 at the paths' own launch sizes, the queue filled ahead:
    # magnify launches each once on its T=600 chunk, the measure K6 once on
    # the T=960 clip.
    band = evm_band(evm_cuda.yiq_pyrdown(clip), cfg)
    planar = evm_cuda.to_planar(clip)
    own = {f"K6 T={EVM_T}": lambda: evm_cuda.yiq_pyrdown(clip),
           f"K6 T={T}": lambda: evm_cuda.yiq_pyrdown(frames),
           f"K7 T={EVM_T}": lambda: evm_recon_cuda.evm_reconstruct(planar,
                                                                   band)}
    own_ms = {k: cuda_ms(fn, inner=3, queue_ahead=True)
              for k, fn in own.items()}
    log("[time] at the paths' own sizes, the queue filled ahead: " + ", ".join(
        f"{k} {t_ms:.4f} ms" for k, t_ms in own_ms.items()))
    k7_own_bound = bound(EVM_T * 2 * frame_bytes + band.numel() * 4,
                         70 * EVM_T * H * W)[0]
    log(f"[time] K7 T={EVM_T}: {own_ms[f'K7 T={EVM_T}']:.4f} ms, bound "
        f"{k7_own_bound:.4f} ms (bytes; "
        f"{k7_own_bound / own_ms[f'K7 T={EVM_T}']:.3f} of it)")
    return dict(launches=launches, k6_ms=times["K6"][0],
                k6_plain=times["K6"][1], k7_ms=times["K7"][0],
                k7_plain=times["K7"][1], k6_bytes=times["K6"][2],
                k7_bytes=times["K7"][2], n=n)


def run_measures(dev, frames, cfg) -> dict:
    """The offline measures beyond the green FFT on the flagship clip: the
    projections, the adaptive selector, FastICA, the app's filtered Welch
    loop and the green measure with the Welch estimator, each in the fused
    form (K1) and the ``"roi"`` form (K2), counters from 0 before each
    call.  Each measure's trace is copied to the CPU and the same port DSP
    run there; each measure runs twice on the card.  Returns the launches
    of K1 (fused calls) and K2 (``"roi"`` calls) in the checked calls."""
    import dataclasses

    import numpy as np
    import torch
    from vhr_tpu_torch.config import ICAConfig
    from vhr_tpu_torch.ops import windows as vwin
    from vhr_tpu_torch.pipeline import offline

    ica = ICAConfig()
    welch = dataclasses.replace(cfg, estimator="welch")
    acq, win = cfg.acquisition_len(FPS), cfg.window_len(FPS)
    ica_acq = int(ica.acquisition_seconds * FPS)
    ica_win = int(ica.window_seconds * FPS)

    def adaptive(b, v):
        bpm, ok, choice, _ = offline.adaptive_pulse_select(b, v, FPS, cfg)
        return bpm, ok & v, choice

    def proj(m):
        return lambda b, v: offline._projection_bpm(b, v, FPS, cfg, m)

    def spec(dsp, measure, first, steady, floor=0.95, tol=3.0,
             valid_same=1.0):
        """A measure: the DSP after the trace, the entry point, its first
        estimating and first steady frame, its validity floor from the
        first, its BPM bound, and the share of frames on which the card's
        validity must equal the CPU's."""
        return dict(dsp=dsp, measure=measure, first=first, steady=steady,
                    floor=floor, tol=tol, valid_same=valid_same)

    # FastICA's float32 convergence test: where it hovers at ``tol`` (the
    # clip's B and R channels are two noise sources of one distribution,
    # which FastICA cannot separate), the last bits of cuSOLVER's and
    # LAPACK's results decide whether a window converges within max_iter,
    # so the card's validity equals the CPU's on most frames, not all.
    specs = {
        "chrom": spec(proj("chrom"), lambda x, f: offline.measure_projection(
            x, FPS, "chrom", cfg, use_pallas=f), acq - 1, win - 1),
        "pos": spec(proj("pos"), lambda x, f: offline.measure_projection(
            x, FPS, "pos", cfg, use_pallas=f), acq - 1, win - 1),
        "omit": spec(proj("omit"), lambda x, f: offline.measure_projection(
            x, FPS, "omit", cfg, use_pallas=f), acq - 1, win - 1),
        "adaptive": spec(adaptive, lambda x, f: offline.measure_adaptive(
            x, FPS, cfg, use_pallas=f), acq - 1, win - 1),
        "ica": spec(lambda b, v: offline._ica_bpm(b, v, FPS, cfg, ica),
                    lambda x, f: offline.measure_ica(x, FPS, cfg, ica,
                                                     use_pallas=f),
                    ica_acq - 1, ica_win - 1, floor=0.90, tol=6.0,
                    valid_same=0.97),
        "app_welch": spec(lambda b, v: offline._app_welch_bpm(b, v, FPS,
                                                              cfg),
                          lambda x, f: offline.measure_app_welch(
                              x, FPS, cfg, use_pallas=f), win, win),
        "green_welch": spec(lambda b, v: offline._green_bpm(b, v, FPS,
                                                            welch),
                            lambda x, f: offline.measure_green_avg(
                                x, FPS, welch, use_pallas=f),
                            win - 1, win - 1)}

    def host(res):
        """A measure's result as numpy ``(bpm, valid[, choice])``."""
        if isinstance(res, offline.AdaptiveResult):
            return res.bpm, res.valid, res.choice
        return res[1:]

    def dsp_host(res):
        """A DSP's tensors as numpy."""
        return tuple(r.cpu().numpy() for r in res)

    traces = {}
    for form in (True, "roi"):
        tr = offline.extract_signals(frames, cfg, use_pallas=form)
        traces[form] = (tr.bgr, tr.valid)
    launches = {"K1": 0, "K2": 0}
    for name, sp in specs.items():
        dsp, measure, first, steady = (sp[k] for k in ("dsp", "measure",
                                                       "first", "steady"))
        for form, tag in ((True, "fused"), ("roi", "roi")):
            t_form = time.perf_counter()
            reset_counters("k1.launches")
            reset_counters("k2.launches", "k2.vec")
            got = host(measure(frames, form))
            torch.cuda.synchronize()
            launched = (counter("k1.launches") if form is True
                        else counter("k2.launches"))
            if launched < 1 or (form == "roi" and counter("k2.vec")
                                != launched):
                raise AssertionError(f"{name} {tag}: its kernel launched "
                                     f"{launched} times")
            launches["K1" if form is True else "K2"] += launched
            again = host(measure(frames, form))
            for a, b in zip(got, again):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{name} {tag}: two card calls "
                                         f"differ")
            bpm, valid = got[0], got[1]
            n_valid, expect = int(valid[first:].sum()), T - first
            share = n_valid / expect
            med = float(np.median(bpm[steady:][valid[steady:]])) \
                if valid[steady:].any() else math.nan
            if share < sp["floor"] or not abs(med - TRUTH_BPM) <= sp["tol"] \
                    or not np.isfinite(bpm).all():
                raise AssertionError(
                    f"{name} {tag}: valid {n_valid}/{expect}, steady median "
                    f"BPM {med}")
            # The same DSP on the CPU, from the card's trace.
            b_cpu, v_cpu = (x.cpu() for x in traces[form])
            cpu = dsp_host(dsp(b_cpu, v_cpu))
            card = dsp_host(dsp(*traces[form]))
            for a, b in zip(card, got):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{name} {tag}: the DSP on the "
                                         f"trace differs from the measure")
            both = valid & cpu[1]
            same = float((cpu[0][both] == bpm[both]).mean())
            v_same = float((cpu[1] == valid).mean())
            if v_same < sp["valid_same"] or same < 0.99 or (
                    len(cpu) > 2 and not np.array_equal(cpu[2], got[2])):
                raise AssertionError(
                    f"{name} {tag}: card against CPU: validity equal on "
                    f"{v_same:.4f} of frames, BPM equal on {same:.4f} of "
                    f"valid frames")
            extra = ""
            if len(got) > 2:
                counts = np.bincount(got[2][valid], minlength=4).tolist()
                extra = f"; choice counts over valid frames {counts}"
            log(f"[measures] {name} {tag} (launches {launched}): valid "
                f"{n_valid}/{expect} ({share:.4f}) from frame {first}; "
                f"steady median BPM {med:.3f}; card == CPU: BPM on "
                f"{same:.4f} of valid frames, validity on {v_same:.4f} of "
                f"frames; two card calls equal bit for bit{extra}; checks "
                f"in {time.perf_counter() - t_form:.1f} s")
        bgr, valid = traces[True]
        ms = cuda_ms(lambda: host(measure(frames, True)))
        dsp_ms = cuda_ms(lambda: dsp_host(dsp(bgr, valid)))
        busy, top = device_profile(lambda: dsp(bgr, valid), top=10 ** 6)
        log(f"[time] measure {name} (fused form, {W}x{H} x {T}): "
            f"{ms:.3f} ms by events; the DSP after the trace {dsp_ms:.3f} "
            f"ms; under the profiler {sum(n for _, _, n in top)} device "
            f"operations, the card busy "
            + (f"{busy:.3f} ms, a busy share of {busy / dsp_ms:.3f} "
               f"of the DSP's time by events" if busy is not None
               else "not traced")
            + "; top: " + ", ".join(f"{k[:40]} {ms_:.3f} ms x{n}"
                                    for k, ms_, n in top[:4]))
    # The app loop's filter stage on its own: the zero-phase band-pass of
    # the 60 windows, a loop of single steps over 930 samples each way.
    bgr, valid = traces[True]
    green = offline._fill_invalid(bgr[:, cfg.channel], valid)
    wins = vwin.sliding_windows(green, win)[1:]
    wins = wins - wins.mean(-1, keepdim=True)
    filt_ms = cuda_ms(lambda: offline._app_filter(wins, FPS, cfg))
    busy, top = device_profile(lambda: offline._app_filter(wins, FPS, cfg),
                               top=10 ** 6)
    log(f"[time] the app loop's sosfiltfilt over {tuple(wins.shape)} "
        f"windows: {filt_ms:.3f} ms by events, "
        f"{sum(n for _, _, n in top)} device operations, the card busy "
        f"{busy if busy is None else round(busy, 3)} ms")
    return launches


def peak_of(fn):
    """(fn's result, device bytes above what was allocated before)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res = fn()
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated() - base


def bpm_check(dev, name: str, bgr, valid, cfg) -> dict:
    """The rolling FFT BPM of a ``(T, 3)`` trace on the card: >= 95 % of
    post-acquisition frames valid, MAE <= 0.5 against the numpy reference
    on the trace's own green."""
    import torch
    from vhr_tpu_torch.ops import windows as vwin
    from vhr_tpu_torch.pipeline import offline
    from vhr_tpu_torch.validation import cpu_reference_green_avg

    acq, win = cfg.acquisition_len(FPS), cfg.window_len(FPS)
    valid_t = torch.as_tensor(valid)
    green = offline._fill_invalid(torch.as_tensor(bgr[:, cfg.channel]),
                                  valid_t)
    rolling = vwin.rolling_bpm_fft(green.to(dev), FPS, cfg.band, win, acq)
    bpm = rolling.bpm.cpu().numpy()
    ok = (rolling.valid.cpu() & valid_t).numpy()
    ref = cpu_reference_green_avg(green.numpy(), FPS, cfg.window_seconds,
                                  cfg.acquisition_seconds, cfg.band)
    expect = len(bpm) - acq + 1
    idx = [i for i in ref if ok[i]]
    mae = (sum(abs(float(bpm[i]) - ref[i]) for i in idx) / len(idx)
           if idx else math.inf)
    log(f"[stream] {name}: valid {int(ok.sum())}/{expect} frames from the "
        f"end of the acquisition; BPM MAE vs numpy reference {mae:.4f} over "
        f"{len(idx)} frames; vs {TRUTH_BPM:g} truth "
        f"{float(abs(bpm[ok] - TRUTH_BPM).mean()):.4f}")
    if ok.sum() < 0.95 * expect or mae > 0.5 or len(idx) < 0.95 * ok.sum():
        raise AssertionError(f"{name}: {int(ok.sum())} valid of {expect}, "
                             f"MAE {mae}")
    return dict(valid=int(ok.sum()), mae=mae)


def run_decoders(dev, path: str, cfg, ref: dict, back) -> dict:
    """The fused stream with DECODERS cv2 decoders against one decoder's
    (equal bits), the reader alone with 1 and DECODERS decoders (decode
    rate, pinned bytes), and an mp4v copy of the clip read with 1 and
    DECODERS decoders (equal bytes)."""
    import numpy as np
    import torch
    from vhr_tpu_torch.io import video as vio
    from vhr_tpu_torch.pipeline import offline

    n_chunks = -(-STREAM_T // STREAM_CHUNK)
    reset_counters("k1.launches")
    ring = {}
    t0 = time.perf_counter()
    (bgr, valid, _), s_peak = peak_of(
        lambda: offline.extract_signals_streaming(
            path, cfg, chunk_frames=STREAM_CHUNK, use_fused=True,
            detect_row_pool=8, n_decoders=DECODERS, ring_stats=ring))
    wall = time.perf_counter() - t0
    launches = counter("k1.launches")
    log(f"[stream] fused, {DECODERS} decoders: K1 launches {launches}; "
        f"{STREAM_T} frames in {wall:.2f} s = {STREAM_T / wall:.1f} "
        f"frames/s from the file "
        f"(1 decoder: {ref['fps']:.1f}); ring {ring}; peak device memory "
        f"{s_peak / 1e9:.3f} GB; os.cpu_count() {os.cpu_count()}")
    if launches != n_chunks:
        raise AssertionError(f"{DECODERS}-decoder stream: K1 launched "
                             f"{launches} times")
    if not (np.array_equal(bgr, ref["bgr"])
            and np.array_equal(valid, ref["valid"])):
        raise AssertionError(f"the {DECODERS}-decoder stream differs from "
                             f"one decoder's")
    decode = {}
    for n in (1, DECODERS):
        t0 = time.perf_counter()
        with vio.ChunkReader(path, STREAM_CHUNK, dev, n_decoders=n) as r:
            got = sum(c.shape[0] for c, _ in r)
            torch.cuda.synchronize()
            pinned, workers = r.pinned_bytes, r.n_workers
        dt = time.perf_counter() - t0
        decode[n] = dict(fps=got / dt, pinned=pinned, workers=workers)
        log(f"[stream] ChunkReader alone, {workers} decoder(s): {got} frames "
            f"to the card in {dt:.2f} s = {got / dt:.1f} frames/s; pinned "
            f"host memory {pinned / 1e9:.3f} GB")
        if got != STREAM_T:
            raise AssertionError(f"the reader gave {got} frames")
    mp4 = os.path.join(os.path.dirname(path), "head.mp4")
    vio.write_video(back[:MP4V_T], mp4, FPS, fourcc="mp4v")
    reads = {}
    for n in (1, DECODERS):
        with vio.ChunkReader(mp4, MP4V_CHUNK, "cpu", n_decoders=n) as r:
            reads[n] = [(c.numpy().copy(), st) for c, st in r]
    same = (len(reads[1]) == len(reads[DECODERS]) and all(
        sa == sb and np.array_equal(a, b)
        for (a, sa), (b, sb) in zip(reads[1], reads[DECODERS])))
    log(f"[stream] mp4v, {MP4V_T} frames in chunks of {MP4V_CHUNK}: "
        f"{DECODERS} decoders == 1 decoder: {same} "
        f"({sum(len(c) for c, _ in reads[1])} frames)")
    if not same:
        raise AssertionError("mp4v: the decoders' chunks differ from one "
                             "decoder's")
    return dict(launches=launches, fps=STREAM_T / wall, ring=ring, peak=s_peak,
                decode=decode)


def run_i420(dev, path: str, cfg, back, ref: dict) -> dict:
    """I420 staging: the card's reconstruction against cv2's on the host,
    both forms of the I420 stream against the whole-clip passes on the
    cv2-rebuilt frames, their BPM, frames/s and peak memory."""
    import cv2
    import numpy as np
    import torch
    from vhr_tpu_torch.ops import color
    from vhr_tpu_torch.pipeline import offline

    n_chunks = -(-STREAM_T // STREAM_CHUNK)
    rebuilt = np.empty_like(back)
    t0 = time.perf_counter()
    for s in range(0, STREAM_T, 64):
        planes = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420)
                           for f in back[s:s + 64]])
        for i, pl in enumerate(planes):
            rebuilt[s + i] = cv2.cvtColor(pl, cv2.COLOR_YUV2BGR_I420)
        got = color.i420_to_bgr_flat(torch.from_numpy(planes).to(dev), H, W)
        got = got.reshape(-1, H, W, 3).cpu().numpy()
        if not np.array_equal(got, rebuilt[s:s + 64]):
            raise AssertionError(
                f"i420_to_bgr_flat differs from cv2 on "
                f"{int((got != rebuilt[s:s + 64]).sum())} bytes of frames "
                f"{s}-{s + len(planes) - 1}")
    log(f"[stream] i420_to_bgr_flat on the card == cv2 COLOR_YUV2BGR_I420 "
        f"on the host, bit for bit, {STREAM_T} frames of {W}x{H} "
        f"({time.perf_counter() - t0:.1f} s with the host conversions)")
    x = torch.from_numpy(rebuilt).to(dev)
    whole = {"fused": offline.extract_signals_fused(x, cfg,
                                                    detect_row_pool=8),
             "detect": offline.extract_signals(x, cfg, use_pallas="roi")}
    planes = torch.from_numpy(np.stack([
        cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420)
        for f in back[:STREAM_CHUNK]])).to(dev)
    rois = whole["detect"].rois[:STREAM_CHUNK]
    times = {"recon": cuda_ms(lambda: color.i420_to_bgr_flat(planes, H, W)),
             "means": cuda_ms(lambda: color.i420_roi_means(planes, rois, H,
                                                           W))}
    del x, planes
    log(f"[time] on one {STREAM_CHUNK}-frame chunk of {W}x{H}: "
        f"i420_to_bgr_flat {times['recon']:.3f} ms, i420_roi_means "
        f"{times['means']:.3f} ms (plain PyTorch, CUDA events)")
    out = dict(times=times)
    for form, kw in (("fused", dict(use_fused=True, detect_row_pool=8)),
                     ("detect", {})):
        reset_counters("k1.launches", "k2.batched")
        ring = {}
        t0 = time.perf_counter()
        (bgr, valid, _), s_peak = peak_of(
            lambda: offline.extract_signals_streaming(
                path, cfg, chunk_frames=STREAM_CHUNK, transfer="i420",
                ring_stats=ring, **kw))
        wall = time.perf_counter() - t0
        k1, k3 = counter("k1.launches"), counter("k2.batched")
        tr = whole[form]
        w_bgr, w_valid = tr.bgr.cpu().numpy(), tr.valid.cpu().numpy()
        err = float(np.abs(bgr - w_bgr).max())
        log(f"[stream] I420 {form}: K1 launches {k1}, K3 {k3}; {STREAM_T} "
            f"frames in {wall:.2f} s = {STREAM_T / wall:.1f} frames/s from "
            f"the file (BGR "
            f"{ref[form]['fps']:.1f}); peak device memory "
            f"{s_peak / 1e9:.3f} GB (BGR {ref[form]['peak'] / 1e9:.3f}); "
            f"ring {ring}; == whole clip on the rebuilt frames: valid "
            f"{np.array_equal(valid, w_valid)}, means max |err| {err:.3g}")
        if form == "fused":
            if k1 != n_chunks or k3:
                raise AssertionError(f"I420 fused stream: K1 launched {k1} "
                                     f"times")
            if not (np.array_equal(bgr, w_bgr)
                    and np.array_equal(valid, w_valid)):
                raise AssertionError("the I420 fused stream differs from "
                                     "the whole-clip pass on the rebuilt "
                                     "frames")
        elif k1 or k3 or not np.array_equal(valid, w_valid) \
                or err > I420_TOL:
            raise AssertionError(f"I420 detect stream: K3 {k3}, valid "
                                 f"equal {np.array_equal(valid, w_valid)}, "
                                 f"means max |err| {err}")
        out[form] = dict(launches=k1, fps=STREAM_T / wall, peak=s_peak,
                         err=err,
                         ring=ring, bpm=bpm_check(dev, f"I420 {form} stream",
                                                  bgr, valid, cfg))
    return out


def subject_frames(subj, n: int):
    """Subject 0's first ``n`` frames as host ``(n, h, w, 3)`` u8, made on
    the card 64 at a time."""
    import numpy as np

    return np.concatenate([
        subj.frames([0] * len(ks), ks).cpu().numpy()
        for ks in (list(range(s, min(s + 64, n))) for s in range(0, n, 64))])


def profiled_submits(pipe, frames, tag: str):
    """LIVE_WARM submits of ``frames`` to ``pipe``, then LIVE_PROFILED more
    under ``torch.profiler`` with ``torch.cuda.set_sync_debug_mode("warn")``:
    no synchronizing operation may be flagged, and the only host waits for
    the card inside the submits are the fetches' event waits.  Returns the
    waits seen inside the window and the kernel launches there."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for f in frames[:LIVE_WARM]:
        pipe.submit(f)
    torch.cuda.synchronize()
    window = frames[LIVE_WARM:LIVE_WARM + LIVE_PROFILED]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function("submits"):
                    for f in window:
                        pipe.submit(f)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    pipe.flush()
    syncs = [str(w.message) for w in caught
             if "synchronizing" in str(w.message).lower()]
    events = prof.events()
    span = next(e.time_range for e in events if e.name == "submits")
    counts, outside, n_kernels = {}, {}, 0
    for e in events:
        inside = span.start <= e.time_range.start <= span.end
        if "Synchronize" in e.name or e.name == "cudaMemcpy":
            side = counts if inside else outside
            side[e.name] = side.get(e.name, 0) + 1
        n_kernels += inside and e.name in ("cudaLaunchKernel",
                                           "cuLaunchKernel",
                                           "cudaLaunchKernelExC")
    log(f"{tag} profiled {LIVE_PROFILED} submits: host waits for the card "
        f"inside the submits {counts} ({LIVE_PROFILED} fetches; outside "
        f"them {outside}), {n_kernels} kernel launches; synchronizing "
        f"operations flagged by torch.cuda.set_sync_debug_mode: "
        f"{len(syncs)}")
    if syncs or set(counts) - {"cudaEventSynchronize"} \
            or counts.get("cudaEventSynchronize", 0) > LIVE_PROFILED:
        raise AssertionError(f"{tag} a submit waited for the card outside "
                             f"its fetch: {counts}, {syncs[:3]}")
    return counts, n_kernels


def run_live(dev) -> dict:
    """``LivePipeline`` on one 720p subject in four modes against the
    sequential step (shifted, equal bits), K4 launched in each, the last
    BPM within BPM_TOL; per-frame latency and host-to-card bytes; one
    profiled window of submits with sync debugging on.  K4 against its
    plain version (equal bits) at the one slot the step gives it, on the
    carries and phases of the sequential runs and of the live app's
    ``--fused`` configuration, and K4's time there."""
    import dataclasses

    import numpy as np
    import torch
    from vhr_tpu_torch.ops import fused_cuda
    from vhr_tpu_torch.pipeline import live

    cfg = live.LiveConfig(fps=FPS, use_fused=True)
    subj = Subjects(dev, 1, PH, PW, SEED + 6)
    bgr = subject_frames(subj, LIVE_FRAMES)
    planar = np.stack([live.bgr_to_i420_host(f) for f in bgr])
    truth = float(subj.bpm[0])
    fields = live.LiveOutput._fields

    # K4's inputs as the live step gives them (one slot, the step's own
    # carries and phases) on the first ticks and every 25th after them.
    k4_kw = {}
    captured = {}
    k4_live = live.fused_detect_roi_slots

    def capture(frames, carry, phase, **kw):
        if k4_kw["tick"] < 16 or k4_kw["tick"] % 25 == 0:
            captured[k4_kw["tag"]].append(
                (frames.clone(), carry.clone(), phase.clone(), kw))
        return k4_live(frames, carry, phase, **kw)

    def sequential(frames, transfer, step_cfg=cfg, tag=None):
        st = live.init_state(step_cfg, dev)
        stp = live.make_step(step_cfg, transfer=transfer)
        vecs = []
        k4_kw["tag"] = tag or f"{transfer}, default"
        captured[k4_kw["tag"]] = []
        live.fused_detect_roi_slots = capture
        try:
            for i, f in enumerate(frames):
                k4_kw["tick"] = i
                st, o = stp(st, torch.from_numpy(f).to(dev))
                vecs.append(live.pack_output(o))
        finally:
            live.fused_detect_roi_slots = k4_live
        return [live.unpack_output(a) for a in torch.stack(vecs).cpu()
                .numpy()]

    ref = {"bgr": sequential(bgr, "bgr"), "i420": sequential(planar, "i420")}
    # The live app's --fused configuration: pooled detection rows, gate.
    app_cfg = dataclasses.replace(cfg, detect_row_pool=8, gate_margin=0.15)
    sequential(planar, "i420", app_cfg, "i420, the app's pool and gate")
    k4_err = 0.0
    for tag, calls in captured.items():
        for frames, carry, phase, kw in calls:
            got, got_c = fused_cuda.fused_detect_roi_slots(
                frames, carry, phase, **kw)
            want, want_c = fused_cuda.fused_detect_roi_slots_plain(
                frames, carry, phase, **kw)
            torch.cuda.synchronize()
            same_bits(f"K4 live {tag}", tuple(got) + (got_c,),
                      tuple(want) + (want_c,))
            k4_err = max(k4_err, compare(f"K4 live {tag}",
                                         tuple(got) + (got_c,),
                                         tuple(want) + (want_c,)))
        n_det = sum(int(c[1][0, 5]) for c in calls)
        log(f"[check] K4 == plain at one {PW}x{PH} live slot ({tag}): "
            f"{len(calls)} ticks of the step's own carries and phases "
            f"(face tracked on {n_det} of them), same bits")
    frames, carry, phase, kw = captured["i420, the app's pool and gate"][-1]
    k4_one = {}
    for name, args in (("default", {}), ("the app's pool and gate", kw)):
        k4_one[name] = (
            cuda_ms(lambda a=args: fused_cuda.fused_detect_roi_slots(
                frames, carry, phase, **a), inner=10, queue_ahead=True),
            cuda_ms(lambda a=args: fused_cuda.fused_detect_roi_slots(
                frames, carry, phase, **a), inner=10),
            cuda_ms(lambda a=args: fused_cuda.fused_detect_roi_slots_plain(
                frames, carry, phase, **a)))
    k4_bound = bound(PH * PW * 3 + (24 + 4 + 34 + 24), 20 * PH * PW)
    log("[time] K4 at one live slot of " + f"{PW}x{PH}: " + "; ".join(
        f"{name} {q:.4f} ms the queue filled ahead, {pc:.4f} ms paced by "
        f"the host, plain {pl:.3f} ms" for name, (q, pc, pl) in
        k4_one.items()) + f"; bound {k4_bound[0]:.6f} ms ({k4_bound[1]})")
    modes = [("bgr", {}), ("i420", dict(transfer="i420")),
             ("fetch_every=4", dict(fetch_every=4)),
             ("frames_per_call=8", dict(frames_per_call=8))]
    out = {}
    for name, kw in modes:
        transfer = kw.get("transfer", "bgr")
        src = planar if transfer == "i420" else bgr
        reset_counters("k4.launches")
        pipe = live.LivePipeline(cfg, **kw)
        sent, outs, lat = [], [], []

        def take(o, now):
            for x in (o if isinstance(o, list) else
                      [] if o is None else [o]):
                lat.append((now - sent[len(outs)]) * 1e3)
                outs.append(x)

        t0 = time.perf_counter()
        for f in src:
            sent.append(time.perf_counter())
            o = pipe.submit(f)
            take(o, time.perf_counter())
        take(pipe.flush(), time.perf_counter())
        wall = time.perf_counter() - t0
        launches = counter("k4.launches")
        want = ref[transfer]
        same = len(outs) == len(want) and all(
            np.array_equal(np.asarray(getattr(a, k)), np.asarray(getattr(b,
                                                                         k)))
            for a, b in zip(outs, want) for k in fields)
        last = outs[-1]
        p50, p90 = np.percentile(lat, [50, 90])
        log(f"[live] {name}: {len(outs)} outputs in {wall:.2f} s "
            f"({LIVE_FRAMES / wall:.1f} frames/s); K4 launches {launches}; "
            f"== sequential step: {same}; latency submit to output p50 "
            f"{p50:.3f} ms p90 {p90:.3f} ms; host-to-card "
            f"{pipe.h2d_bytes / LIVE_FRAMES:.0f} bytes/frame; last BPM "
            f"{float(last.bpm):.3f} (valid {bool(last.bpm_valid)}) vs truth "
            f"{truth:.3f}")
        if launches != LIVE_FRAMES or not same or not bool(last.bpm_valid) \
                or abs(float(last.bpm) - truth) > BPM_TOL:
            raise AssertionError(f"live {name}: K4 {launches}, equal "
                                 f"{same}, last {last}")
        out[name] = dict(p50=p50, p90=p90, fps=LIVE_FRAMES / wall,
                         h2d=pipe.h2d_bytes / LIVE_FRAMES, launches=launches)

    # One profiled window of submits: the host's waits for the card inside
    # it (the profiler's own synchronize on exit falls outside).
    counts, n_kernels = profiled_submits(live.LivePipeline(cfg), bgr,
                                         "[live]")
    out["profile"] = dict(counts=counts, kernels=n_kernels)
    out["bgr_frames"], out["truth"] = bgr, truth
    out["k4_err"] = k4_err
    return out


def run_pool_i420(dev) -> dict:
    """The 64 x 720p fused pool with ``transfer="i420"`` beside the BGR pool
    on the same frames for I420_TICKS ticks: K4 launched, ``face_valid``
    equal on every tick, ``green_raw`` within I420_TOL; the tick wall
    times."""
    import numpy as np
    from vhr_tpu_torch import serving
    from vhr_tpu_torch.pipeline import live

    cfg = live.LiveConfig(fps=FPS, use_fused=True)
    pools = {t: serving.BpmServer(cfg, n_slots=SLOTS, transfer=t)
             for t in ("bgr", "i420")}
    for pool in pools.values():
        for _ in range(SLOTS):
            pool.attach()
    subj = Subjects(dev, SLOTS, PH, PW, SEED + 7)
    reset_counters("k4.launches")
    walls = {"bgr": [], "i420": []}
    worst, face_same = 0.0, True
    for t in range(I420_TICKS):
        frames = subj.frames(range(SLOTS), [t] * SLOTS).cpu().numpy()
        send = {"bgr": {s: frames[s] for s in range(SLOTS)},
                "i420": {s: live.bgr_to_i420_host(frames[s])
                         for s in range(SLOTS)}}
        outs = {}
        for k, pool in pools.items():
            t0 = time.perf_counter()
            outs[k] = pool.tick(send[k])
            walls[k].append((time.perf_counter() - t0) * 1e3)
        for s in range(SLOTS):
            a, b = outs["bgr"][s], outs["i420"][s]
            face_same &= bool(a.face_valid) == bool(b.face_valid)
            worst = max(worst, abs(float(a.green_raw) - float(b.green_raw)))
    launches = counter("k4.launches")
    med = {k: statistics.median(v) for k, v in walls.items()}
    log(f"[pool i420] {SLOTS} x {PW}x{PH}, {I420_TICKS} ticks beside the BGR "
        f"pool: K4 launches {launches}; face_valid equal on every tick "
        f"{face_same}; green_raw max |diff| {worst:.4f} u8; tick wall time "
        f"(host copy into pinned memory, upload, tick, fetch) median: BGR "
        f"{med['bgr']:.3f} ms, I420 {med['i420']:.3f} ms")
    if launches != 2 * I420_TICKS or not face_same or worst > I420_TOL:
        raise AssertionError(f"I420 pool: K4 {launches}, face_valid equal "
                             f"{face_same}, green_raw |diff| {worst}")
    return dict(launches=launches, wall=med, worst=worst)


def run_server_i420(dev) -> dict:
    """One ``BpmClient(transfer="i420")`` against a 4-slot fused I420 pool
    behind ``serve_forever``: one line per frame, in order, the last
    ``bpm_valid`` within BPM_TOL."""
    import numpy as np
    from vhr_tpu_torch import serving
    from vhr_tpu_torch.pipeline import live

    pool = serving.BpmServer(live.LiveConfig(fps=FPS, use_fused=True),
                             n_slots=4, transfer="i420")
    subj = Subjects(dev, 1, PH, PW, SEED + 8)
    planar = [live.bgr_to_i420_host(f)
              for f in subject_frames(subj, SERVE_FRAMES)]
    srv = serving.serve_forever("127.0.0.1", 0, pool, frame_shape=(PH, PW))
    try:
        t0 = time.perf_counter()
        c = serving.BpmClient("127.0.0.1", srv.server_address[1],
                              transfer="i420")
        lines = []
        reader = threading.Thread(
            target=lambda: lines.extend(c.recv() for _ in planar))
        reader.start()
        for f in planar:
            c.send(f)
        reader.join(timeout=600)
        c.close()
        wall = time.perf_counter() - t0
    finally:
        srv.shutdown()
        srv.server_close()
    truth = float(subj.bpm[0])
    end = lines[-1] if lines else {}
    log(f"[server i420] 1 client x {SERVE_FRAMES} frames of {PW}x{PH} I420 "
        f"({planar[0].nbytes} bytes each) in {wall:.2f} s "
        f"({SERVE_FRAMES / wall:.1f} frames/s); last line {end} vs truth "
        f"{truth:.3f}")
    if [ln.get("seq") for ln in lines] != list(range(SERVE_FRAMES)) \
            or not end.get("bpm_valid") or abs(end["bpm"] - truth) > BPM_TOL:
        raise AssertionError(f"I420 server: {len(lines)} lines, last {end}")
    return dict(wall=wall)


def run_apps(dev, frames, truth: float) -> dict:
    """The live app (``--fused --transfer i420``) on the live subject as an
    MJPG file, and the serving app's client mode against a served I420
    pool; both on the card."""
    import contextlib
    import io

    import numpy as np
    from vhr_tpu_torch import serving
    from vhr_tpu_torch.apps import rppg_livestream, serve_bpm
    from vhr_tpu_torch.io import video as vio
    from vhr_tpu_torch.pipeline import live

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "subject.avi")
        vio.write_video(frames, path, FPS, fourcc="MJPG")
        reset_counters("k4.launches")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = rppg_livestream.main(["--video", path, "--no-display",
                                       "--fused", "--transfer", "i420"])
        wall = time.perf_counter() - t0
        text = buf.getvalue().splitlines()
        bpms = [float(ln.split(":")[1]) for ln in text
                if ln.startswith("Bpm after filtering")]
        med = float(np.median(bpms[-60:])) if bpms else math.nan
        log(f"[apps] rppg_livestream --fused --transfer i420: exit {rc} in "
            f"{wall:.1f} s; K4 launches {counter('k4.launches')}; "
            f"{len(bpms)} BPM lines, median of the last 60 {med:.3f} vs "
            f"truth {truth:.3f}; its last line: {text[-1] if text else ''}")
        if rc != 0 or counter("k4.launches") < 1 or len(bpms) < 60 \
                or abs(med - truth) > BPM_TOL:
            raise AssertionError(f"rppg_livestream: exit {rc}, median "
                                 f"{med}")
        out["livestream"] = dict(wall=wall, median=med)

        pool = serving.BpmServer(live.LiveConfig(fps=FPS, use_fused=True),
                                 n_slots=4, transfer="i420")
        srv = serving.serve_forever("127.0.0.1", 0, pool,
                                    frame_shape=(PH, PW))
        buf = io.StringIO()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = serve_bpm.main(["--connect",
                                     f"127.0.0.1:{srv.server_address[1]}",
                                     "--video", path, "--max-frames",
                                     str(APP_CLIENT_FRAMES)])
            wall = time.perf_counter() - t0
        finally:
            srv.shutdown()
            srv.server_close()
        text = buf.getvalue().splitlines()
        log(f"[apps] serve_bpm --connect: exit {rc} in {wall:.1f} s; "
            f"{text[0] if text else ''} ... {text[-1] if text else ''}")
        if rc != 0 or f"sent {APP_CLIENT_FRAMES} frames" not in text \
                or any("server error" in ln for ln in text):
            raise AssertionError(f"serve_bpm client mode: exit {rc}, "
                                 f"{text[-3:]}")
        out["client"] = dict(wall=wall)
    return out


def run_streaming(dev, frames, cfg) -> dict:
    """Streaming ingest of the flagship clip's first STREAM_T frames from an
    MJPG file: both forms
    of ``extract_signals_streaming`` against the whole-clip passes on the
    read-back frames, and ``measure_green_avg_file``; counters from 0
    before each, read after."""
    import numpy as np
    import torch
    from vhr_tpu_torch.io import video as vio
    from vhr_tpu_torch.pipeline import offline
    from vhr_tpu_torch.validation import cpu_reference_green_avg

    n_chunks = -(-STREAM_T // STREAM_CHUNK)
    frames = frames[:STREAM_T]
    out = {}

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.avi")
        t0 = time.perf_counter()
        vio.write_video(frames.cpu().numpy(), path, FPS, fourcc="MJPG")
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, fps = vio.read_video(path)
        t_read = time.perf_counter() - t0
        log(f"[stream] wrote {STREAM_T} frames of {W}x{H} MJPG in "
            f"{t_write:.1f} s "
            f"({os.path.getsize(path) / 1e6:.1f} MB); read_video took "
            f"{t_read:.1f} s ({STREAM_T / t_read:.1f} frames/s)")
        if back.shape != (STREAM_T, H, W, 3) or fps != FPS:
            raise AssertionError(f"read back {back.shape} at {fps} fps")

        for form, kw in (("detect", {}),
                         ("fused", dict(use_fused=True, detect_row_pool=8))):
            key = "k2.batched" if form == "detect" else "k1.launches"
            reset_counters(key, "k2.vec")
            ring = {}
            t0 = time.perf_counter()
            (bgr, valid, s_fps), s_peak = peak_of(
                lambda: offline.extract_signals_streaming(
                    path, cfg, chunk_frames=STREAM_CHUNK, ring_stats=ring,
                    **kw))
            wall = time.perf_counter() - t0
            launches = counter(key)
            name = "K3" if form == "detect" else "K1"
            log(f"[stream] {form}: {name} launches {launches}; {STREAM_T} "
                f"frames in {wall:.2f} s = {STREAM_T / wall:.1f} frames/s "
                f"from the file; "
                f"ring {ring}")
            if launches < 1 or (form == "fused" and launches != n_chunks):
                raise AssertionError(f"{form} stream: {name} launched "
                                     f"{launches} times")
            if form == "detect" and counter("k2.vec") != launches:
                raise AssertionError(
                    f"detect stream: {counter('k2.vec')} of "
                    f"{launches} K3 launches on the vectorised instance")

            def whole_pass():
                x = torch.as_tensor(back).to(dev)
                if form == "detect":
                    tr = offline.extract_signals(x, cfg, use_pallas="roi")
                else:
                    tr = offline.extract_signals_fused(x, cfg,
                                                       detect_row_pool=8)
                return tr.bgr.cpu().numpy(), tr.valid.cpu().numpy()

            (w_bgr, w_valid), w_peak = peak_of(whole_pass)
            err = float(np.abs(bgr - w_bgr).max())
            log(f"[stream] {form}: valid {int(valid.sum())}/{STREAM_T}, == "
                f"whole "
                f"clip: valid {np.array_equal(valid, w_valid)}, means max "
                f"|err| {err:.3g}; peak device memory: stream "
                f"{s_peak / 1e9:.3f} GB, whole clip {w_peak / 1e9:.3f} GB")
            if (s_fps != FPS or not np.array_equal(valid, w_valid)
                    or not np.array_equal(bgr, w_bgr)):
                raise AssertionError(f"{form} stream differs from the "
                                     f"whole-clip pass (max |err| {err})")
            out[form] = dict(launches=launches, fps=STREAM_T / wall, ring=ring,
                             peak=s_peak, whole_peak=w_peak, bgr=bgr,
                             valid=valid)

        out["decoders"] = run_decoders(dev, path, cfg, out["fused"], back)
        out["i420"] = run_i420(dev, path, cfg, back, out)
        reset_counters("k1.launches")
        t0 = time.perf_counter()
        _, bpm, valid = offline.measure_green_avg_file(
            path, cfg, chunk_frames=STREAM_CHUNK, use_fused=True,
            detect_row_pool=8)
        wall = time.perf_counter() - t0
        if counter("k1.launches") != n_chunks:
            raise AssertionError(f"measure_green_avg_file: K1 launched "
                                 f"{counter('k1.launches')} times")
    f = out["fused"]
    green = offline._fill_invalid(torch.as_tensor(f["bgr"][:, cfg.channel]),
                                  torch.as_tensor(f["valid"])).numpy()
    ref = cpu_reference_green_avg(green, FPS, cfg.window_seconds,
                                  cfg.acquisition_seconds, cfg.band)
    expect = STREAM_T - cfg.acquisition_len(FPS) + 1
    idx = [i for i in ref if valid[i]]
    mae = (sum(abs(float(bpm[i]) - ref[i]) for i in idx) / len(idx)
           if idx else math.inf)
    log(f"[stream] measure_green_avg_file (fused, K1 x "
        f"{counter('k1.launches')}): {STREAM_T / wall:.1f} frames/s from the "
        f"file; "
        f"valid {int(valid.sum())}/{expect} frames from the end of the "
        f"acquisition; BPM "
        f"MAE vs numpy reference {mae:.4f} over {len(idx)} frames; vs "
        f"{TRUTH_BPM:g} truth {float(abs(bpm[valid] - TRUTH_BPM).mean()):.4f}")
    if valid.sum() < 0.95 * expect or mae > 0.5 \
            or len(idx) < 0.95 * valid.sum():
        raise AssertionError(f"measure_green_avg_file: {int(valid.sum())} "
                             f"valid of {expect}, MAE {mae}")
    out["measure_fps"] = STREAM_T / wall
    return out


def draw_face(h: int, w: int, scale: float, cy=None, cx=None):
    """``tests/test_mediapipe_face.py``'s schematic face (skin ellipse,
    hair, eyes, brows, nose, mouth) drawn ``scale`` times its size centred
    in an ``h x w`` frame (at row ``cy`` and column ``cx`` if given): ``(u8
    BGR image, bool skin-ellipse mask, ellipse box [x1, y1, x2, y2])``."""
    import cv2
    import numpy as np

    def s(v):
        return int(round(v * scale))

    cx = w // 2 if cx is None else cx
    cy, rx, ry = h // 2 if cy is None else cy, s(55), s(75)
    img = np.full((h, w, 3), (60, 70, 80), np.uint8)
    cv2.ellipse(img, (cx, cy), (rx, ry), 0, 0, 360, (130, 165, 200), -1)
    cv2.ellipse(img, (cx, cy - ry + s(18)), (rx - s(6), s(26)), 0, 180, 360,
                (40, 60, 80), -1)
    for ex in (cx - s(22), cx + s(22)):
        cv2.circle(img, (ex, cy - s(15)), s(9), (255, 255, 255), -1)
        cv2.circle(img, (ex, cy - s(15)), s(5), (40, 30, 30), -1)
        cv2.line(img, (ex - s(12), cy - s(30)), (ex + s(12), cy - s(32)),
                 (50, 50, 60), s(3))
    cv2.line(img, (cx, cy - s(5)), (cx - s(6), cy + s(14)), (90, 120, 150),
             s(3))
    cv2.ellipse(img, (cx, cy + s(34)), (s(18), s(9)), 0, 0, 180,
                (60, 60, 120), s(3))
    mask = np.zeros((h, w), np.uint8)
    cv2.ellipse(mask, (cx, cy), (rx, ry), 0, 0, 360, 1, -1)
    return img, mask.astype(bool), (cx - rx, cy - ry, cx + rx, cy + ry)


def make_face_clip(dev, t: int, h: int, w: int, seed: int = SEED,
                   chunk: int = 64):
    """``(t, h, w, 3)`` u8 clip of :func:`draw_face` made on ``dev``: the
    face sways +-MP_SWAY px (whole pixels), its skin ellipse carries a
    TRUTH_BPM green pulse of 2 u8, 0-7 u8 of seeded sensor noise; and the
    ``(t, 4)`` float ellipse boxes."""
    import torch

    img, mask, box = draw_face(h, w, MP_SCALE)
    base = torch.as_tensor(img, device=dev).to(torch.float32)
    skin = torch.as_tensor(mask, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = torch.empty((t, h, w, 3), dtype=torch.uint8, device=dev)
    ts = torch.arange(t, dtype=torch.float64) / FPS
    dx = torch.round(MP_SWAY * torch.sin(2 * math.pi * 0.1 * ts)).long()
    pulse = 2.0 * torch.sin(2 * math.pi * TRUTH_BPM / 60.0 * ts)
    for s0 in range(0, t, chunk):
        idx = range(s0, min(t, s0 + chunk))
        img_c = torch.stack([torch.roll(base, int(dx[i]), 1) for i in idx])
        on = torch.stack([torch.roll(skin, int(dx[i]), 1) for i in idx])
        amp = pulse[list(idx)].to(device=dev, dtype=torch.float32)
        img_c[..., 1] += on * amp[:, None, None]
        img_c += torch.randint(0, 8, img_c.shape, generator=gen,
                               device=dev).to(torch.float32)
        frames[s0:s0 + len(idx)] = img_c.clamp(0, 255).to(torch.uint8)
    boxes = torch.tensor(box, dtype=torch.float64).repeat(t, 1)
    boxes[:, 0::2] += dx[:, None].double()
    return frames, boxes


def make_face_duo(dev, t: int, h: int, w: int, scale: float,
                  bpms=DUO_BPM, seed: int = SEED, chunk: int = 64):
    """``(t, h, w, 3)`` u8 clip of two :func:`draw_face` faces side by side
    (centred at a quarter and three quarters of the width) made on
    ``dev``: each skin ellipse carries its own 2 u8 green pulse at
    ``bpms``, both sway +-MP_SWAY px (whole pixels), 0-7 u8 of seeded
    sensor noise."""
    import torch

    left, lmask, _ = draw_face(h, w, scale, cx=w // 4)
    right, rmask, _ = draw_face(h, w, scale, cx=3 * w // 4)
    img = left.copy()
    img[:, w // 2:] = right[:, w // 2:]
    base = torch.as_tensor(img, device=dev).to(torch.float32)
    skins = [torch.as_tensor(m, device=dev) for m in (lmask, rmask)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = torch.empty((t, h, w, 3), dtype=torch.uint8, device=dev)
    ts = torch.arange(t, dtype=torch.float64) / FPS
    dx = torch.round(MP_SWAY * torch.sin(2 * math.pi * 0.1 * ts)).long()
    for s0 in range(0, t, chunk):
        idx = list(range(s0, min(t, s0 + chunk)))
        img_c = torch.stack([torch.roll(base, int(dx[i]), 1) for i in idx])
        for skin, bpm in zip(skins, bpms):
            on = torch.stack([torch.roll(skin, int(dx[i]), 1) for i in idx])
            amp = (2.0 * torch.sin(2 * math.pi * bpm / 60.0 * ts[idx])).to(
                device=dev, dtype=torch.float32)
            img_c[..., 1] += on * amp[:, None, None]
        img_c += torch.randint(0, 8, img_c.shape, generator=gen,
                               device=dev).to(torch.float32)
        frames[s0:s0 + len(idx)] = img_c.clamp(0, 255).to(torch.uint8)
    return frames


def box_iou(a, b):
    """IoU of corresponding ``[x1, y1, x2, y2]`` rows (float tensors)."""
    import torch

    lt = torch.maximum(a[:, :2], b[:, :2])
    rb = torch.minimum(a[:, 2:], b[:, 2:])
    inter = (rb - lt).clamp(min=0).prod(1)
    area = lambda x: (x[:, 2:] - x[:, :2]).clamp(min=0).prod(1)
    return inter / (area(a) + area(b) - inter)


def k5_ops(C: int, Cm: int, S: int, n_blocks: int = 4):
    """Operations of one residual stage on one frame, (all of them, those
    of the two 1x1 convs, which K5 does on the tensor cores): per pixel and
    block 4*C*Cm (the two 1x1 convs, a multiply and an add each; the
    algorithm's, not the three TF32 passes') + 18*Cm (the 3x3 depthwise
    conv) + 3*Cm (bias, PReLU) + 4*C (bias, residual add, PReLU); 2*C per
    pixel for the entry PReLU."""
    convs = S * n_blocks * 4 * C * Cm
    return convs + S * (n_blocks * (21 * Cm + 4 * C) + 2 * C), convs


def mesh_stages(params, lm_fused):
    """The mesh net's residual stages that run on K5: ``[(stage, packed
    weights)]`` in graph order."""
    from vhr_tpu_torch.ops import meshblocks_cuda as mb

    return [(st, mb.StageWeights(*(params.lm[f"_fs{start}_{i}"]
                                   for i in range(9))))
            for start, st in sorted(lm_fused.stages.items())]


def check_k5(x, wts, w_row: int):
    """K5 on ``x`` against its plain version: float32 within ``K5_F32_TOL``
    of max|y|, bfloat16 within one bf16 ulp of each value (or that bound
    where it is larger).  Returns (max |err|, max|y|); raises when the
    kernel's result has another dtype or shape or lies outside the bound,
    naming the first element that does."""
    import torch
    from vhr_tpu_torch.ops import meshblocks_cuda as mb

    got = mb.residual_stage(x, wts, w_row)
    want = mb.residual_stage_plain(x, wts, w_row)
    torch.cuda.synchronize()
    g, w_ = got.float(), want.float()
    err = (g - w_).abs()
    scale = float(w_.abs().max())
    tol = torch.full_like(err, K5_F32_TOL * scale)
    if x.dtype != torch.float32:
        big = torch.maximum(g.abs(), w_.abs()).clamp_min(1e-30)
        tol = torch.maximum(tol, torch.exp2(torch.floor(torch.log2(big)) - 7))
    bad = (~(err <= tol)).nonzero()
    if got.dtype != x.dtype or got.shape != x.shape or len(bad):
        where = tuple(bad[0].tolist()) if len(bad) else None
        raise AssertionError(
            f"K5 {tuple(x.shape)} w_row={w_row} {x.dtype}: max |err| "
            f"{float(err.max())}, max|y| {scale}, {len(bad)} values outside "
            f"the bound, the first at {where}: "
            f"{float(g[where]) if where else None} against "
            f"{float(w_[where]) if where else None}")
    return float(err.max()), scale


def detector_split(params, det_apply, lm_fused, lm_plain, frames) -> dict:
    """Milliseconds of each step of ``mediapipe_face._detect_single`` over
    ``frames`` in the detector's slices (CUDA events, each step on the
    previous step's outputs): letterbox, BlazeFace, decode + NMS + ROI,
    axis crop, the mesh net with its stages on K5 and unfused, and the
    landmark projection + box."""
    import torch
    from vhr_tpu_torch.models import mediapipe_face as mpf

    bf16 = torch.bfloat16
    n, h, w = frames.shape[:3]
    sl = mpf._slices(n)
    anchors = torch.as_tensor(mpf.blazeface_anchors(), device=frames.device)
    with torch.no_grad():
        boxed = [mpf._letterbox(frames[s], 128, -1.0, 1.0, bf16) for s in sl]
        raw = [det_apply(params.det, x) for x in boxed]

        def nms():
            out = [mpf._weighted_nms(*mpf._decode_detections(r, c, anchors),
                                     1) for r, c in raw]
            b, _, kp, _ = (torch.cat(p) for p in zip(*out))
            r = mpf._detection_to_rect(b, kp, h, w)
            return r._replace(rot=torch.zeros_like(r.rot))

        rects = nms()
        crops = [mpf._crop_faces(frames[s], mpf._Rect(*(f[s] for f in rects)),
                                 256, "axis", bf16)[:, 0] for s in sl]
        lm = torch.cat([lm_fused(params.lm, c)[0] for c in crops])
        return {
            "letterbox": cuda_ms(lambda: [mpf._letterbox(
                frames[s], 128, -1.0, 1.0, bf16) for s in sl]),
            "BlazeFace": cuda_ms(lambda: [det_apply(params.det, x)
                                          for x in boxed]),
            "decode+NMS+ROI": cuda_ms(nms),
            "crop": cuda_ms(lambda: [mpf._crop_faces(
                frames[s], mpf._Rect(*(f[s] for f in rects)), 256, "axis",
                bf16) for s in sl]),
            "mesh (K5)": cuda_ms(lambda: [lm_fused(params.lm, c)
                                          for c in crops]),
            "mesh (unfused)": cuda_ms(lambda: [lm_plain(params.lm, c)
                                               for c in crops]),
            "project+box": cuda_ms(lambda: mpf._landmarks_to_bbox(
                mpf._project_landmarks(lm.reshape(n, 1, 478, 3), rects)[:, 0],
                h, w))}


def run_mediapipe(dev, cfg) -> dict:
    """The production MediaPipe detector at 1080p x T: K5 against its plain
    version at the mesh net's four stages, the executors against the numpy
    oracle, the offline measure with the fused detector (counters from 0
    before it, read after), the fused against the unfused detector, then
    the times."""
    import copy

    import numpy as np
    import torch
    from vhr_tpu_torch.models import mediapipe_face as mpf
    from vhr_tpu_torch.models import tflite, tflite_exec
    from vhr_tpu_torch.ops import meshblocks_cuda as mb
    from vhr_tpu_torch.pipeline import offline
    from vhr_tpu_torch.validation import cpu_reference_green_avg

    t0 = time.perf_counter()
    frames, ell = make_face_clip(dev, T, H, W, seed=SEED + 8)
    bf16 = torch.bfloat16
    params, det_apply, lm_fused = mpf.load_face_models(
        activation_dtype=bf16, fuse_stages=True)
    params_u, det_u, lm_plain = mpf.load_face_models(activation_dtype=bf16)
    torch.cuda.synchronize()
    log(f"[mediapipe] clip {tuple(frames.shape)} and both nets on the card "
        f"in {time.perf_counter() - t0:.1f} s")

    def det(x):
        return mpf._detect_single(params, det_apply, lm_fused, x)

    # K5 against its plain version at the four stage shapes, bundled
    # weights, random N(0, 1) stage inputs, at each batch the product
    # detector gives it: B = the detector's slice (an offline measure, a
    # sweep, the skin pool's 64 slots) and B = 1 (the live step's one frame
    # a call).
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    stages = mesh_stages(params, lm_fused)
    k5_err, k5_inputs = 0.0, []
    for st, wts in stages:
        C, Hs, Ws = st["C"], st["H"], st["W"]
        for B in (mpf._SLICE, 1):
            x = torch.randn((B, C, Hs * Ws), generator=gen, device=dev)
            if B == mpf._SLICE:
                k5_inputs.append(x)
            for dtype in (torch.float32, bf16):
                xi = x.to(dtype)
                err, scale = check_k5(xi, wts, Ws)
                k5_err = max(k5_err, err)
                log(f"[check] K5 == plain at {Hs}x{Ws} C={C} Cm={st['Cm']} "
                    f"x {B} {str(dtype)[6:]}: max |err| {err:.3g} (max|y| "
                    f"{scale:.3g})")

    # The executors (float32, unfused and fused) against the numpy oracle
    # on one frame of each net: the clip's letterboxed frame and face crop.
    graphs = tflite.load_task_models(mpf.default_task_path())
    rects, _, _ = mpf.detect_faces_mp(params, det_apply, frames[:1])
    rects = rects._replace(rot=torch.zeros_like(rects.rot))
    inputs = {"face_detector.tflite":
              mpf._letterbox(frames[:1], 128, -1.0, 1.0),
              "face_landmarks_detector.tflite":
              mpf._crop_faces(frames[:1], rects, 256, "axis")[:, 0]}
    for name, x in inputs.items():
        oracle = tflite_exec.NumpyInterpreter(
            copy.deepcopy(graphs[name].graph))(x.cpu().numpy())
        for fuse in (False, True) if "landmarks" in name else (False,):
            p, apply = tflite_exec.build_torch(
                copy.deepcopy(graphs[name].graph), fuse_stages=fuse)
            with torch.no_grad():
                ys = apply(p, x)
            err = max(float(np.abs(y.cpu().numpy() - o).max())
                      / max(float(np.abs(o).max()), 1.0)
                      for y, o in zip(ys, oracle))
            log(f"[check] executor {name} float32, {len(apply.stages)} "
                f"stages on K5, == numpy oracle: max |err| / max|y| "
                f"{err:.3g} (bound {EXEC_TOL[name]:g})")
            if err > EXEC_TOL[name]:
                raise AssertionError(f"executor {name} fuse={fuse}: {err}")

    # The main path, counters from 0.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counters("k5.launches", "k2.launches", "k2.vec")
    _, bpm, valid = offline.measure_green_avg(frames, FPS, cfg, detector=det,
                                              use_pallas="roi")
    torch.cuda.synchronize()
    launches = {"K5": counter("k5.launches"), "K2": counter("k2.launches"),
                "K2 vectorised": counter("k2.vec")}
    peak = torch.cuda.max_memory_allocated() - base
    log(f"[mediapipe] kernel launches in the measure: {launches}; peak "
        f"device memory above the phase's {peak / 1e9:.3f} GB")
    if min(launches.values()) < 1 or launches["K2 vectorised"] != \
            launches["K2"]:
        raise AssertionError(f"a kernel of the MediaPipe measure never "
                             f"launched, or K2 left the vectorised "
                             f"instance: {launches}")
    trace = offline.extract_signals(frames, cfg, detector=det,
                                    use_pallas="roi")
    green = offline._fill_invalid(trace.bgr[:, cfg.channel], trace.valid)
    ref = cpu_reference_green_avg(green.cpu().numpy(), FPS,
                                  cfg.window_seconds,
                                  cfg.acquisition_seconds, cfg.band)
    expect = T - cfg.acquisition_len(FPS) + 1
    idx = [i for i in ref if valid[i]]
    mae_ref = (sum(abs(float(bpm[i]) - ref[i]) for i in idx) / len(idx)
               if idx else math.inf)
    mae_truth = float(abs(bpm[valid] - TRUTH_BPM).mean())
    tv = trace.valid.cpu()
    iou = box_iou(trace.boxes.cpu().double()[tv], ell[tv])
    log(f"[mediapipe] measure: detector valid {int(tv.sum())}/{T} frames; "
        f"valid {int(valid.sum())}/{expect} frames from the end of the "
        f"acquisition; BPM "
        f"MAE vs numpy reference {mae_ref:.4f} over {len(idx)} frames; vs "
        f"{TRUTH_BPM:g} BPM truth {mae_truth:.4f}; landmark box IoU with "
        f"the skin ellipse's box min {float(iou.min()):.3f} mean "
        f"{float(iou.mean()):.3f}")
    if (valid.sum() < 0.95 * expect or len(idx) < 0.95 * valid.sum()
            or mae_ref > 0.5 or not np.isfinite(bpm).all()
            or float(iou.min()) < MP_IOU_MIN):
        raise AssertionError(f"MediaPipe measure: {int(valid.sum())} valid "
                             f"of {expect}, MAE {mae_ref}, IoU min "
                             f"{float(iou.min())}")

    # Fused against unfused: the detector with its nets op by op, and the
    # landmarks of both mesh nets on the same detections.
    def unfused(x):
        return mpf._detect_single(params_u, det_u, lm_plain, x)

    b_f, v_f = det(frames)
    b_u, v_u = unfused(frames)
    agree = float((v_f == v_u).double().mean())
    both = v_f & v_u
    box_d = int((b_f - b_u)[both].abs().max()) if bool(both.any()) else 0
    with torch.no_grad():
        rects, _, _ = mpf.detect_faces_mp(params, det_apply, frames)
        lm_f, _ = mpf.face_landmarks(params, lm_fused, frames, rects)
        lm_u, _ = mpf.face_landmarks(params, lm_plain, frames, rects)
        small, _, _ = draw_face(256, 320, 1.0, cy=130)  # the JAX test's
        ref_rect, _, _ = mpf.detect_faces_mp(
            params, det_apply, torch.as_tensor(small[None], device=dev))
    diff = (lm_f - lm_u)[both]
    rms = float((diff ** 2).mean().sqrt())
    per_crop = 256.0 / rects.side[both][..., None, None]
    rms_crop = float(((diff * per_crop) ** 2).mean().sqrt())
    rms_tol = MP_RMS_PX * 256.0 / float(ref_rect.side)
    log(f"[mediapipe] fused vs unfused detector: validity equal on "
        f"{agree:.4f} of {T} frames, boxes within {box_d} px, landmark "
        f"RMS {rms:.4f} px over {int(both.sum())} frames (ROI side "
        f"{float(rects.side[both].mean()):.1f} px), {rms_crop:.4f} px of "
        f"the 256-px crop; bound {MP_RMS_PX:g} px on the JAX test's face "
        f"(ROI side {float(ref_rect.side):.1f} px) = {rms_tol:.3f} crop px")
    if agree < 0.99 or rms_crop > rms_tol:
        raise AssertionError(f"fused vs unfused: agree {agree}, RMS "
                             f"{rms_crop} crop px")

    # The product detector (make_mediapipe_detector, which --detector
    # mediapipe resolves to) as the live step calls it, one frame a call:
    # K5 at B=1 in every call, validity against the unfused detector's, and
    # both mesh nets' landmarks at B=1 on the same detections, under the
    # clip's bound.
    product = mpf.make_mediapipe_detector()
    picks = list(range(0, T, max(1, T // MP_SINGLE_N)))[:MP_SINGLE_N]
    before = counter("k5.launches")
    v_one = torch.cat([product(frames[i:i + 1])[1] for i in picks])
    torch.cuda.synchronize()
    k5_one = counter("k5.launches") - before
    v_ref = torch.cat([unfused(frames[i:i + 1])[1] for i in picks])
    agree_1 = float((v_one == v_ref).double().mean())
    d1 = []
    with torch.no_grad():
        for i in picks:
            r, _, _ = mpf.detect_faces_mp(params, det_apply,
                                          frames[i:i + 1])
            f_, _ = mpf.face_landmarks(params, lm_fused, frames[i:i + 1], r)
            u_, _ = mpf.face_landmarks(params, lm_plain, frames[i:i + 1], r)
            d1.append((f_ - u_) * 256.0 / r.side[..., None, None])
    rms_1 = float((torch.cat(d1)[v_one & v_ref] ** 2).mean().sqrt())
    log(f"[mediapipe] product detector one frame a call (the live step's "
        f"B=1), {len(picks)} frames: K5 launches {k5_one} ({len(stages)} a "
        f"call expected); validity equal to the unfused detector's on "
        f"{agree_1:.4f} of them; landmarks fused vs unfused at B=1 RMS "
        f"{rms_1:.4f} px of the 256-px crop (bound {rms_tol:.3f})")
    if k5_one != len(stages) * len(picks) or agree_1 < 0.99 \
            or not rms_1 <= rms_tol:
        raise AssertionError(f"product detector at B=1: K5 launches "
                             f"{k5_one}, validity equal on {agree_1}, "
                             f"landmark RMS {rms_1} crop px")

    # Times (CUDA events, median of 3 after a warm-up).
    m_ms = {"fused": cuda_ms(lambda: offline.measure_green_avg(
                frames, FPS, cfg, detector=det, use_pallas="roi")),
            "unfused": cuda_ms(lambda: offline.measure_green_avg(
                frames, FPS, cfg, detector=unfused, use_pallas="roi"))}
    d_ms = {"fused": cuda_ms(lambda: det(frames)),
            "unfused": cuda_ms(lambda: unfused(frames))}
    for form in m_ms:
        log(f"[time] MediaPipe measure ({form} mesh) at {W}x{H} x {T}: "
            f"{m_ms[form]:.3f} ms = {T / (m_ms[form] / 1e3):.1f} frames/s; "
            f"detection alone {d_ms[form]:.3f} ms = "
            f"{d_ms[form] * 1e3 / T:.3f} us/frame")
    busy, top = device_profile(lambda: offline.measure_green_avg(
        frames, FPS, cfg, detector=det, use_pallas="roi"))
    if busy is None:
        log("[profile] MediaPipe measure (fused mesh): the profiler traced "
            "no device work; busy share not measured")
    else:
        log(f"[profile] MediaPipe measure (fused mesh): the card busy "
            f"{busy:.3f} ms of the {m_ms['fused']:.3f} ms the measure takes "
            f"(idle share {1 - busy / m_ms['fused']:.3f}); top kernels (ms, "
            f"calls): " + "; ".join(f"{k[:60]} {ms:.3f} x{n}"
                                     for k, ms, n in top))
    split = detector_split(params, det_apply, lm_fused, lm_plain, frames)
    log(f"[time] MediaPipe detector at {W}x{H} x {T}, step by step (ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    n_slices = -(-T // mpf._SLICE)
    k5 = {"ms": 0.0, "plain": 0.0, "unfused": 0.0, "bytes": 0.0, "ops": 0.0,
          "conv_ops": 0.0}
    for (st, wts), x in zip(stages, k5_inputs):
        C, Hs, Ws = st["C"], st["H"], st["W"]
        xb = x.to(bf16)
        ops = lm_plain.graph.operators[st["start"]:st["start"] + st["n_ops"]]

        def op_by_op():
            env = {st["in_tensor"]: xb.reshape(mpf._SLICE, C, Hs, Ws)}
            get = lambda i: env[i] if i in env else params.lm[str(i)]
            for op in ops:
                env[op.outputs[0]] = lm_plain._op(op, get,
                                                  lm_plain.graph.tensors)
            return env[st["out_tensor"]]

        with torch.no_grad():
            t_k = cuda_ms(lambda: mb.residual_stage(xb, wts, Ws), inner=20,
                          queue_ahead=True)
            t_f32 = cuda_ms(lambda: mb.residual_stage(x, wts, Ws), inner=20,
                            queue_ahead=True)
            t_host = cuda_ms(lambda: mb.residual_stage(xb, wts, Ws),
                             inner=20)
            t_p = cuda_ms(lambda: mb.residual_stage_plain(xb, wts, Ws))
            t_u = cuda_ms(op_by_op, inner=10)
        log(f"[time] K5 stage {Hs}x{Ws} C={C} Cm={st['Cm']} x {mpf._SLICE} "
            f"bf16: kernel {t_k:.4f} ms ({t_f32:.4f} ms in float32; "
            f"{t_host:.4f} ms paced by the host), plain "
            f"{t_p:.4f} ms, the same {st['n_ops']} ops unfused (cuDNN, "
            f"op by op) {t_u:.4f} ms")
        k5["ms"] += t_k * n_slices
        k5["plain"] += t_p * n_slices
        k5["unfused"] += t_u * n_slices
        k5["bytes"] += 2 * 2 * C * Hs * Ws * T + 4 * sum(
            w.numel() for w in wts) * n_slices
        ops, convs = k5_ops(C, st["Cm"], Hs * Ws)
        k5["ops"] += ops * T
        k5["conv_ops"] += convs * T
    log(f"[time] K5 for the run ({n_slices} slices x {len(stages)} "
        f"stages): kernel {k5['ms']:.3f} ms, plain {k5['plain']:.3f} ms, "
        f"unfused stages {k5['unfused']:.3f} ms")
    return dict(frames=frames, launches=launches, k5_err=k5_err, k5=k5,
                peak=peak, m_ms=m_ms, d_ms=d_ms, split=split,
                mae_ref=mae_ref, mae_truth=mae_truth, agree=agree, rms=rms,
                rms_crop=rms_crop)


def run_landmark_slice(dev, frames, cfg, card: str) -> dict:
    """The multi-face MediaPipe detector and the landmark ROI forms on the
    card (phase 8b): the K=2 measure on a two-face 1080p clip and K5
    against its plain version at the batch it gives K5; the pose-robust
    and the polygon measures on the MediaPipe phase's clip ``frames``;
    the video app with ``--faces 2 --detector mediapipe``,
    ``LivePipeline(k_faces=2)`` and a K=2 pool with the detector.  Counters
    from 0 before each path, read after.  Returns the K5 launches, K5's
    error and times at B=128, and each check's time."""
    import contextlib
    import io

    import numpy as np
    import torch
    from vhr_tpu_torch import serving
    from vhr_tpu_torch.apps import rppg_video
    from vhr_tpu_torch.config import PipelineConfig
    from vhr_tpu_torch.io import video as vio
    from vhr_tpu_torch.models import mediapipe_face as mpf
    from vhr_tpu_torch.ops import meshblocks_cuda as mb
    from vhr_tpu_torch.pipeline import live, offline
    from vhr_tpu_torch.validation import cpu_reference_green_avg

    out = {"launches": {}, "s": {}}
    t_phase = time.perf_counter()
    bf16 = torch.bfloat16

    # The K=2 path: two drawn faces side by side at 1080p, the product
    # multi-face detector (bf16 activations, the mesh's stages on K5),
    # the measure with the app's 10 s windows.
    t0 = time.perf_counter()
    duo = make_face_duo(dev, MPM_T, H, W, MP_SCALE, seed=SEED + 10)
    det = mpf.make_mediapipe_detector_multi(k_faces=2)
    mcfg = PipelineConfig(window_seconds=10.0, acquisition_seconds=5.0)
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    t0 = time.perf_counter()
    reset_counters("k5.launches")
    trace = offline.extract_signals_multi(duo, 2, mcfg, detector=det)
    _, bpm, valid = offline.measure_green_avg_multi(duo, FPS, 2, mcfg,
                                                    trace=trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5 = out["launches"]["K=2 measure"] = counter("k5.launches")
    expect = MPM_T - mcfg.acquisition_len(FPS) + 1
    n_valid = valid.sum(0).tolist()
    last = [float(bpm[np.nonzero(valid[:, k])[0][-1], k])
            if valid[:, k].any() else math.nan for k in range(2)]
    tv, tb = trace.valid.cpu(), trace.boxes.cpu()
    both = tv.all(1)
    ordered = bool((tb[both][:, 0, 2] < tb[both][:, 1, 0]).all())
    log(f"[landmark] K=2 MediaPipe measure on {tuple(duo.shape)} (made in "
        f"{t_make:.1f} s): {wall:.2f} s; K5 launches {k5}; "
        f"detector valid on both faces {int(both.sum())}/{MPM_T} frames, "
        f"boxes in x-order {ordered}; valid {n_valid} of {expect} frames "
        f"from the end of the acquisition; last valid BPM {last} (truth "
        f"{list(DUO_BPM)})")
    if k5 < 1 or not ordered or min(n_valid) < 0.95 * expect \
            or not all(abs(last[k] - DUO_BPM[k]) <= BPM_TOL
                       for k in range(2)):
        raise AssertionError(f"K=2 MediaPipe measure: K5 {k5}, "
                             f"x-order {ordered}, valid {n_valid} of "
                             f"{expect}, last BPM {last}")
    out["s"]["K=2 measure"] = wall
    del trace

    # K5 against its plain version at the batch the K=2 detector gives it
    # (two crops a frame, slices of 64 frames), then its time there.
    params, _, lm_fused = mpf.load_face_models(activation_dtype=bf16,
                                               fuse_stages=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    B = 2 * mpf._SLICE
    out["k5_err"], out["k5_ms"], out["k5_bytes"] = 0.0, {}, {}
    for st, wts in mesh_stages(params, lm_fused):
        C, Hs, Ws = st["C"], st["H"], st["W"]
        x = torch.randn((B, C, Hs * Ws), generator=gen, device=dev)
        for dtype in (torch.float32, bf16):
            err, scale = check_k5(x.to(dtype), wts, Ws)
            out["k5_err"] = max(out["k5_err"], err)
            log(f"[check] K5 == plain at {Hs}x{Ws} C={C} Cm={st['Cm']} x {B}"
                f" {str(dtype)[6:]}: max |err| {err:.3g} (max|y| "
                f"{scale:.3g})")
        xb = x.to(bf16)
        with torch.no_grad():
            t_k = cuda_ms(lambda: mb.residual_stage(xb, wts, Ws), inner=20,
                          queue_ahead=True)
        nbytes = 2 * 2 * B * C * Hs * Ws + 4 * sum(w.numel() for w in wts)
        ops, convs = k5_ops(C, st["Cm"], Hs * Ws)
        b_ms, by = bound(nbytes, ops * B, convs * B)
        out["k5_ms"][f"{Hs}x{Ws}"] = t_k
        log(f"[time] K5 stage {Hs}x{Ws} C={C} x {B} bf16: {t_k:.4f} ms, the "
            f"queue filled ahead; bound {b_ms:.4f} ms ({by})")

    # The pose-robust ROI and the mesh polygon on the MediaPipe phase's
    # clip, the flagship configuration.
    acq = cfg.acquisition_len(FPS)
    clip_f32 = frames.numel() * 4
    for name, run, make in (
            ("pose-robust ROI", offline.extract_signals_landmark_roi,
             mpf.make_mediapipe_roi_detector),
            ("polygon", offline.extract_signals_polygon,
             mpf.make_mediapipe_poly_detector)):
        det1 = make()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counters("k5.launches")
        t0 = time.perf_counter()
        trace = run(frames, det1, cfg)
        bpm_t, ok_t = offline._green_bpm(trace.bgr, trace.valid, FPS, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        k5 = out["launches"][name] = counter("k5.launches")
        green = offline._fill_invalid(trace.bgr[:, cfg.channel], trace.valid)
        ref = cpu_reference_green_avg(green.cpu().numpy(), FPS,
                                      cfg.window_seconds,
                                      cfg.acquisition_seconds, cfg.band)
        bpm1, ok1 = bpm_t.cpu().numpy(), ok_t.cpu().numpy()
        n_ok = int(ok1.sum())
        idx = [i for i in ref if ok1[i]]
        mae = (sum(abs(float(bpm1[i]) - ref[i]) for i in idx) / len(idx)
               if idx else math.inf)
        roi = trace.rois[trace.valid].float()
        side = (roi[:, 2:] - roi[:, :2]).mean(0).tolist() if len(roi) else []
        log(f"[landmark] {name} measure on {tuple(frames.shape)}: "
            f"{wall:.2f} s; K5 launches {k5}; detector valid "
            f"{int(trace.valid.sum())}/{T}; valid {n_ok}/{T - acq + 1} "
            f"frames from the end of the acquisition; BPM MAE vs numpy "
            f"reference {mae:.4f} over {len(idx)} frames; mean ROI "
            f"{side} px; peak device memory above the clip "
            f"{peak / 1e9:.3f} GB (the clip in float32: "
            f"{clip_f32 / 1e9:.1f} GB)")
        if k5 < 1 or n_ok < 0.95 * (T - acq + 1) \
                or len(idx) < 0.95 * n_ok or mae > 0.5 \
                or not np.isfinite(bpm1).all() or peak > clip_f32 / 8:
            raise AssertionError(f"{name} measure: K5 {k5}, "
                                 f"{n_ok} valid, MAE {mae}, peak {peak}")
        out["s"][name] = wall
        out[f"peak {name}"] = peak
        del trace

    tmp_dir = tempfile.TemporaryDirectory()
    try:
        # The video app with --faces 2 --detector mediapipe on the two-face
        # clip as MJPG.
        t0 = time.perf_counter()
        dpath = os.path.join(tmp_dir.name, "duo.avi")
        vio.write_video(duo.cpu().numpy(), dpath, FPS, fourcc="MJPG")
        del duo
        t_write = time.perf_counter() - t0
        kept, inner = [], rppg_video.analyze_multi

        def keep(*a, **kw):
            kept.append(inner(*a, **kw))
            return kept[-1]

        rppg_video.analyze_multi = keep
        buf = io.StringIO()
        reset_counters("k5.launches")
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = rppg_video.main([dpath, "--out-dir",
                                      os.path.join(tmp_dir.name, "video"),
                                      "--faces", "2", "--detector",
                                      "mediapipe"])
        finally:
            rppg_video.analyze_multi = inner
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k5 = out["launches"]["rppg_video"] = counter("k5.launches")
        faces = dict(ln.split(" BPM: ") for ln in buf.getvalue().splitlines()
                     if ln.startswith("face"))
        b, v = kept[0]["boxes"], kept[0]["valid"]
        ordered = bool((b[v.all(1)][:, 0, 2] < b[v.all(1)][:, 1, 0]).all())
        log(f"[landmark] rppg_video --faces 2 --detector mediapipe on "
            f"{MPM_T} frames of {W}x{H} MJPG (written in {t_write:.1f} s): "
            f"exit {rc} in {wall:.2f} s; K5 launches {k5}; {faces}; "
            f"both faces valid on {int(v.all(1).sum())} frames, boxes in "
            f"x-order {ordered}")
        if rc != 0 or k5 < 1 or set(faces) != {"face0", "face1"} \
                or not ordered or any(
                    abs(float(faces[f"face{k}"]) - DUO_BPM[k]) > BPM_TOL
                    for k in range(2)):
            raise AssertionError(f"rppg_video --faces 2 mediapipe: exit "
                                 f"{rc}, K5 {k5}, {faces}, x-order "
                                 f"{ordered}")
        out["s"]["rppg_video --faces 2 mediapipe"] = wall
        del kept
    finally:
        tmp_dir.cleanup()

    # LivePipeline(k_faces=2) and a 4-slot K=2 pool with the detector, on
    # two faces at 720p: a live stream's BPM settles once its ring holds no
    # start-up transient of the causal filter.
    lduo = make_face_duo(dev, MPM_LIVE_T, PH, PW, MP_SCALE * PH / H,
                         seed=SEED + 12)
    lcfg = live.LiveConfig(fps=FPS)
    host = lduo.cpu().numpy()
    pipe = live.LivePipeline(lcfg, detector=det, k_faces=2)
    reset_counters("k5.launches")
    t0 = time.perf_counter()
    got = [o for o in map(pipe.submit, host) if o is not None]
    got.append(pipe.flush())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5 = out["launches"]["LivePipeline"] = counter("k5.launches")
    last = got[-1]
    log(f"[landmark] LivePipeline(k_faces=2) with the MediaPipe detector on "
        f"{MPM_LIVE_T} frames of {PW}x{PH}: {wall:.2f} s "
        f"({MPM_LIVE_T / wall:.1f} frames/s); K5 launches {k5}; "
        f"last BPM {last.bpm.tolist()} valid {last.bpm_valid.tolist()}")
    if len(got) != MPM_LIVE_T or k5 < 1 \
            or not last.bpm_valid.all() or any(
                abs(float(last.bpm[k]) - DUO_BPM[k]) > BPM_TOL
                for k in range(2)):
        raise AssertionError(f"LivePipeline(k_faces=2) mediapipe: K5 "
                             f"{k5}, last {last}")
    out["s"]["LivePipeline k_faces=2 mediapipe"] = wall
    del host

    pool = serving.BpmServer(lcfg, n_slots=DUO_SLOTS, k_faces=2,
                             detector=det)
    for _ in range(DUO_SLOTS):
        pool.attach()
    mirrored = lduo.flip(2)
    reset_counters("k5.launches")
    t0 = time.perf_counter()
    for i in range(MPM_LIVE_T):
        outs = pool.tick({s: (lduo[i] if s < 2 else mirrored[i])
                          for s in range(DUO_SLOTS)})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5 = out["launches"]["pool"] = counter("k5.launches")
    ends = {s: (outs[s].bpm.tolist(), outs[s].bpm_valid.tolist())
            for s in range(DUO_SLOTS)}
    want = {s: DUO_BPM if s < 2 else DUO_BPM[::-1] for s in range(DUO_SLOTS)}
    log(f"[landmark] pool k_faces=2 with the MediaPipe detector, {DUO_SLOTS} "
        f"slots x {MPM_LIVE_T} ticks of {PW}x{PH}: {wall:.2f} s; K5 "
        f"launches {k5}; last BPM and validity {ends}")
    if k5 < 1 or any(not all(ends[s][1]) or any(
            abs(ends[s][0][k] - want[s][k]) > BPM_TOL for k in range(2))
            for s in range(DUO_SLOTS)):
        raise AssertionError(f"pool k_faces=2 mediapipe: K5 {k5}, "
                             f"{ends}")
    out["s"]["pool k_faces=2 mediapipe"] = wall
    del lduo, mirrored, pool
    out["s"]["phase"] = time.perf_counter() - t_phase
    log(f"[landmark] check times ({card}): " + ", ".join(
        f"{k} {v:.2f} s" for k, v in out["s"].items()))
    return out


def start_real_face_clip() -> dict:
    """Start making phase 8c's animated real portrait on the host (numpy
    and cv2, some 85 ms a frame) in a thread, so that it is ready by phase
    8c: a dict that gets ``"clip"`` (or ``"error"``) and ``"s"``, and holds
    the ``"thread"``."""
    import threading

    from vhr_tpu_torch.utils import realface

    real = {}

    def make():
        t0 = time.perf_counter()
        try:
            real["clip"] = realface.synthesize_real_face_clip(
                bpm=TRUTH_BPM, fps=FPS, duration_s=REAL_T / FPS,
                scale=REAL_SCALE)
        except Exception as e:              # re-raised in phase 8c
            real["error"] = e
        real["s"] = time.perf_counter() - t0

    real["thread"] = threading.Thread(target=make, daemon=True)
    real["thread"].start()
    return real


def learned_measure(name, det, x, truth, mcfg, iou_min, out):
    """One single-face measure of a learned detector ``det`` with K2
    (phases 8c and 16): its gates (K2 launched, >= 95% valid after the
    acquisition, BPM MAE at most 0.5 against the numpy reference on the
    port's own trace, the last valid BPM within LEARNED_BPM_TOL of the
    truth, the boxes' mean IoU with ``truth`` at least ``iou_min``), K2
    against its plain version on the measure's ROIs; K2's launches, error
    and the wall time go into ``out``.  Returns the trace."""
    import numpy as np
    import torch
    from vhr_tpu_torch.ops import roi_means_cuda
    from vhr_tpu_torch.pipeline import offline
    from vhr_tpu_torch.validation import cpu_reference_green_avg

    n = x.shape[0]
    expect = n - mcfg.acquisition_len(FPS) + 1
    reset_counters("k2.launches", "k2.vec")
    t0 = time.perf_counter()
    _, bpm, valid = offline.measure_green_avg(x, FPS, mcfg, detector=det,
                                              use_pallas="roi")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2, vec = counter("k2.launches"), counter("k2.vec")
    out["launches"][name] = k2
    trace = offline.extract_signals(x, mcfg, det, use_pallas="roi")
    green = offline._fill_invalid(trace.bgr[:, mcfg.channel],
                                  trace.valid)
    ref = cpu_reference_green_avg(green.cpu().numpy(), FPS,
                                  mcfg.window_seconds,
                                  mcfg.acquisition_seconds, mcfg.band)
    idx = [i for i in ref if valid[i]]
    mae = (sum(abs(float(bpm[i]) - ref[i]) for i in idx) / len(idx)
           if idx else math.inf)
    n_valid = int(valid.sum())
    last = (float(bpm[np.nonzero(valid)[0][-1]]) if valid.any()
            else math.nan)
    ok = trace.valid
    iou = box_iou(trace.boxes[ok].float(), truth[ok].float())
    mean_iou = float(iou.mean()) if len(iou) else 0.0
    log(f"[learned] {name} measure on {tuple(x.shape)}: {wall:.2f} s; "
        f"K2 launches {k2} (vectorised {vec}); "
        f"detector valid {int(ok.sum())}/{n}; valid {n_valid}/{expect} "
        f"frames from the end of the acquisition; last valid BPM "
        f"{last:.3f} (truth {TRUTH_BPM:g}); BPM MAE vs numpy reference "
        f"{mae:.4f} over {len(idx)} frames; mean IoU with the truth "
        f"boxes {mean_iou:.4f} (min {float(iou.min()):.4f})")
    if k2 < 1 or n_valid < 0.95 * expect or len(idx) < 0.95 * n_valid \
            or mae > 0.5 or abs(last - TRUTH_BPM) > LEARNED_BPM_TOL \
            or mean_iou < iou_min or not np.isfinite(bpm).all():
        raise AssertionError(f"{name} measure: K2 {k2}, valid {n_valid}"
                             f" of {expect}, last BPM {last}, MAE {mae},"
                             f" IoU {mean_iou}")
    out["k2_err"] = max(out["k2_err"], check_roi_means(
        roi_means_cuda.roi_channel_means_cuda, "K2",
        [(f"{name}", x, trace.rois, {})]))
    out["s"][name] = wall
    return trace


def run_learned_slice(dev, frames, truth_boxes, cfg, card: str,
                      real: dict) -> dict:
    """The learned landmarker and the cascade detectors on the card (phase
    8c), at the shipped config (bf16, stem 48, blocks 64-384): the
    ``landmarker`` and ``refined`` detectors through ``measure_green_avg(
    use_pallas="roi")`` on the flagship clip ``frames`` (K2 launched and
    held against its plain version on their ROIs); ``landmarker-real`` on
    the animated real portrait; the tiled ``landmarker`` and the
    ``refined`` cascade through ``measure_green_avg_multi`` on a two-face
    720p clip; ``LivePipeline`` with the landmarker on one 720p subject;
    the float32 landmarker on the card against the CPU.  ``real`` is
    :func:`start_real_face_clip`'s.  Counters from 0 before each single-face
    path, read after.  Returns K2's launches and error, and each check's
    time."""
    import numpy as np
    import torch
    from vhr_tpu_torch.apps import rppg_video
    from vhr_tpu_torch.config import PipelineConfig
    from vhr_tpu_torch.models import landmarker as lmk
    from vhr_tpu_torch.ops import roi_means_cuda
    from vhr_tpu_torch.pipeline import live, offline
    from vhr_tpu_torch.utils import realface

    out = {"launches": {}, "s": {}, "ms": {}, "k2_err": 0.0}
    t_phase = time.perf_counter()

    # 1. landmarker and refined on the flagship clip, through the apps'
    # detector choices (weights from checkpoints/*.npz, on the card).
    for name in ("landmarker", "refined"):
        t0 = time.perf_counter()
        det = rppg_video._resolve_detector(name)
        log(f"[learned] {name}: weights loaded in "
            f"{time.perf_counter() - t0:.2f} s")
        learned_measure(name, det, frames, truth_boxes, cfg, LEARNED_IOU_MIN,
                        out)
        out["ms"][name] = cuda_ms(lambda: det(frames), reps=1)
        log(f"[time] {name} detector alone on {tuple(frames.shape)}: "
            f"{out['ms'][name]:.1f} ms, {out['ms'][name] / len(frames):.3f} "
            f"ms a frame ({card})")

    # 2. The float32 landmarker on the card against the CPU on the clip's
    # first 16 frames (TF32 convolutions would miss 1e-4), and the shipped
    # bf16 config against float32 on the card.
    import dataclasses
    f32 = dataclasses.replace(lmk.LandmarkerConfig(),
                              compute_dtype=torch.float32)
    x16 = frames[:16]
    got = {}
    for tag, cfg_, d in (("card f32", f32, dev), ("cpu f32", f32, "cpu"),
                         ("card bf16", lmk.LandmarkerConfig(), dev)):
        model = lmk.build_model(lmk.load_params(device=d), cfg_, d)
        got[tag] = [t.cpu() for t in lmk._landmarks(model, x16.to(d))]
    card_cpu = float((got["card f32"][0] - got["cpu f32"][0]).abs().max())
    bf_f32 = float((got["card bf16"][0] - got["card f32"][0]).abs().max())
    pres = float((got["card f32"][1] - got["cpu f32"][1]).abs().max())
    log(f"[check] landmarker float32, card against CPU on 16 frames: "
        f"landmarks max |diff| {card_cpu:.3g} (bound {LANDMARK_F32_TOL:g}), "
        f"presence {pres:.3g}; bf16 against float32 on the card: "
        f"landmarks max |diff| {bf_f32:.3g}")
    if card_cpu > LANDMARK_F32_TOL:
        raise AssertionError(f"float32 landmarks card vs CPU {card_cpu}")
    out["landmarks card vs cpu"], out["landmarks bf16 vs f32"] = \
        card_cpu, bf_f32

    # 3. Multi-face: the tiled landmarker and the refined cascade on two
    # faces at 720p (phase 14's geometry), 10 s windows.
    duo = make_duo(dev, DUO_APP_T, PH, PW, seed=SEED + 14)
    mcfg = PipelineConfig(window_seconds=10.0, acquisition_seconds=5.0)
    steady = mcfg.window_len(FPS)
    for name in ("landmarker", "refined"):
        det = rppg_video._resolve_detector_multi(name, 2)
        t0 = time.perf_counter()
        _, bpm, valid = offline.measure_green_avg_multi(duo, FPS, 2, mcfg,
                                                        detector=det)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        err = np.abs(bpm[steady:] - np.asarray(DUO_BPM)[None, :]).mean(0)
        n_ok = valid[steady:].sum(0).tolist()
        log(f"[learned] K=2 {name} measure on {tuple(duo.shape)}: "
            f"{wall:.2f} s; valid {n_ok} of {DUO_APP_T - steady} steady "
            f"frames; mean |BPM - truth| {err.tolist()} (truth "
            f"{list(DUO_BPM)})")
        if not valid[steady:].all() or (err > DUO_LEARNED_TOL).any():
            raise AssertionError(f"K=2 {name}: valid {n_ok}, err {err}")
        out["s"][f"K=2 {name}"] = wall
    del duo

    # 4. LivePipeline with the landmarker on one 720p subject.  The last
    # step's frame and the ROIs it gave K2 are kept (a copy on the card),
    # to hold K2 against its plain version at the live step's shape.
    subj = Subjects(dev, 1, PH, PW, SEED + 15)
    host = subject_frames(subj, LEARNED_LIVE_T)
    truth_bpm = float(subj.bpm[0])
    pipe = live.LivePipeline(live.LiveConfig(fps=FPS),
                             detector=rppg_video._resolve_detector(
                                 "landmarker"))
    step_k2, last_step = live.roi_channel_means_cuda, {}

    def keep_step(x, rois, **kw):
        last_step["args"] = (x.clone(), rois.clone())
        return step_k2(x, rois, **kw)

    live.roi_channel_means_cuda = keep_step
    reset_counters("k2.launches")
    lat, got_out = [], []
    t0 = time.perf_counter()
    try:
        for f in host:
            t1 = time.perf_counter()
            o = pipe.submit(f)
            lat.append((time.perf_counter() - t1) * 1e3)
            if o is not None:
                got_out.append(o)
        got_out.append(pipe.flush())
        torch.cuda.synchronize()
    finally:
        live.roi_channel_means_cuda = step_k2
    wall = time.perf_counter() - t0
    k2 = counter("k2.launches")
    out["launches"]["LivePipeline"] = k2
    last = got_out[-1]
    p50 = statistics.median(lat)
    log(f"[learned] LivePipeline with the landmarker on {LEARNED_LIVE_T} "
        f"frames of {PW}x{PH}: {wall:.2f} s, submit p50 {p50:.3f} ms a "
        f"frame ({card}); K2 launches {k2}; last BPM {float(last.bpm):.3f} "
        f"valid {bool(last.bpm_valid)} (truth {truth_bpm:.3f})")
    if len(got_out) != LEARNED_LIVE_T or k2 < 1 or not bool(last.bpm_valid) \
            or abs(float(last.bpm) - truth_bpm) > BPM_TOL:
        raise AssertionError(f"LivePipeline landmarker: K2 {k2}, {last}")
    x1, rois1 = last_step["args"]
    r = rois1.tolist()
    n1, h1, w1, c1 = x1.shape
    plan = roi_means_cuda.roi_plan(
        n1, h1, w1, c1, h1 * w1 * c1, w1 * c1,
        roi_means_cuda.alignment(x1.data_ptr()),
        roi_means_cuda.sm_count(x1.device.index or 0))
    log(f"[learned] LivePipeline's last step gave K2 {tuple(x1.shape)} "
        f"with ROIs {r}; its launch {plan}")
    if not all(x1_ > x0 and y1_ > y0 for x0, y0, x1_, y1_ in r):
        raise AssertionError(f"LivePipeline landmarker: empty ROI {r}")
    out["k2_err"] = max(out["k2_err"], check_roi_means(
        roi_means_cuda.roi_channel_means_cuda, "K2",
        [("LivePipeline landmarker", x1, rois1, {})]))
    out["s"]["LivePipeline landmarker"] = wall
    out["live p50 ms"] = p50
    del host

    # 5. landmarker-real on the animated real portrait.
    t0 = time.perf_counter()
    real["thread"].join()
    if "error" in real:
        raise real["error"]
    clip = real.pop("clip")
    log(f"[learned] real portrait clip {clip.frames.shape} made on the "
        f"host in {real['s']:.1f} s, in a thread since phase 2 (waited "
        f"{time.perf_counter() - t0:.1f} s for it here)")
    x = torch.from_numpy(clip.frames).to(dev)
    truth = torch.from_numpy(clip.face_boxes).to(dev)
    del clip
    det = rppg_video._resolve_detector("landmarker-real")
    rcfg = PipelineConfig(window_seconds=10.0, acquisition_seconds=5.0)
    learned_measure("landmarker-real", det, x, truth, rcfg, REAL_IOU_MIN, out)
    import cv2
    photo = realface.real_face_image()
    still = cv2.resize(photo, (round(photo.shape[1] * REAL_SCALE),
                               round(photo.shape[0] * REAL_SCALE)),
                       interpolation=cv2.INTER_AREA)       # as the clip's
    still = torch.from_numpy(still).to(dev)[None]
    b, v = det(still)
    want = torch.tensor([round(c * REAL_SCALE)
                         for c in realface.REAL_FACE_BOX], device=dev)
    one = float(box_iou(b.float(), want[None].float())[0])
    log(f"[learned] landmarker-real on the still portrait at "
        f"{REAL_SCALE}x: valid {bool(v[0])}, box {b[0].tolist()}, IoU with "
        f"the MediaPipe box {one:.4f}")
    if not bool(v[0]) or one < REAL_IOU_MIN:
        raise AssertionError(f"landmarker-real on the portrait: IoU {one}")
    del x, truth
    out["s"]["phase"] = time.perf_counter() - t_phase
    log(f"[learned] check times ({card}): " + ", ".join(
        f"{k} {v:.2f} s" for k, v in out["s"].items()))
    return out


_BATCH_WORKER = """
import sys, time
import numpy as np
from vhr_tpu_torch.models import realgen, train
out, seed = sys.argv[1], int(sys.argv[2])
cfg = train.TrainConfig()
for name, fn, n in (
        ("scratch", train.synth_batch, int(sys.argv[3])),
        ("finetune", realgen.make_mixed_batch_fn(real_frac=0.25),
         int(sys.argv[4]))):
    rng, batches, times = np.random.default_rng(seed), [], []
    for _ in range(n):
        t0 = time.perf_counter()
        batches.append(fn(cfg, rng))
        times.append(time.perf_counter() - t0)
    np.savez(f"{out}/{name}.npz", times=np.asarray(times),
             **{k: np.stack([b[k] for b in batches]) for k in batches[0]})
"""


def start_train_batches() -> dict:
    """Start drawing phase 16's batches on the host in a worker process
    (numpy and cv2, some 0.2 s a batch of 64), so that they are ready by
    phase 16: the trainer's own draws (``train.synth_batch`` from scratch,
    ``realgen.make_mixed_batch_fn(real_frac=0.25)`` for the fine-tune,
    each from ``np.random.default_rng(SEED)``, the seed ``--seed`` gives
    the trainer), saved with each draw's host time.  Returns the process
    and its temporary directory."""
    import atexit

    tmp = tempfile.TemporaryDirectory()
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-c", _BATCH_WORKER, tmp.name, str(SEED),
         str(TRAIN_STEPS), str(FT_STEPS)], cwd=repo,
        env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    # A phase that fails before phase 16 must not leave the worker behind.
    atexit.register(lambda: proc.poll() is None and (proc.kill(),
                                                     proc.wait()))
    return {"proc": proc, "tmp": tmp}


def replay_batches(path: str):
    """A ``batch_fn`` that hands out the batches saved at ``path`` in
    order, and their host draw times; it raises past the last one."""
    import numpy as np

    with np.load(path) as z:
        arrays = {k: z[k] for k in ("image", "landmarks", "has_face")}
        times = z["times"]
    served = []

    def batch_fn(cfg, rng):
        i = len(served)
        served.append(i)
        return {k: v[i] for k, v in arrays.items()}

    batch_fn.served, batch_fn.arrays = served, arrays
    return batch_fn, times


def run_training(dev, frames, truth_boxes, cfg, card: str,
                 batches: dict) -> dict:
    """The trainer on the card (phase 16), through ``train.main`` at full
    width: from scratch (losses finite and falling), the JAX package's
    fine-tune recipe from ``checkpoints/landmarker.npz`` (held-out IoU,
    the checkpoint reloaded bit for bit), the reloaded weights as the
    ``landmarker`` detector through the K2 measure on the flagship clip
    ``frames``, the dp×tp step on a (2, 2) mesh of places against the
    unsharded one, and ``entry.dryrun_multichip(4)``.  ``batches`` is
    :func:`start_train_batches`'s: the trainer's own batch source is
    replaced by those draws (the same bits: the first of each is drawn
    again here and compared).  Returns K2's launches and error, and each
    check's time."""
    import dataclasses

    import numpy as np
    import torch
    from vhr_tpu_torch import entry
    from vhr_tpu_torch.models import landmarker as lmk
    from vhr_tpu_torch.models import realgen
    from vhr_tpu_torch.models import train as vtrain
    from vhr_tpu_torch.parallel.mesh import train_mesh

    out = {"launches": {}, "s": {}, "k2_err": 0.0}
    t_phase = time.perf_counter()
    proc, tmp = batches["proc"], batches["tmp"]
    try:
        text = proc.communicate(timeout=300)[0].decode(errors="replace")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"batch worker exit {proc.returncode}:\n"
                             f"{text[-3000:]}")
    waited = time.perf_counter() - t_phase
    scratch_fn, scratch_t = replay_batches(os.path.join(tmp.name,
                                                        "scratch.npz"))
    ft_fn, ft_t = replay_batches(os.path.join(tmp.name, "finetune.npz"))
    log(f"[train] {len(scratch_t)} + {len(ft_t)} batches drawn on the host "
        f"by a worker process started after phase 2, in "
        f"{float(scratch_t.sum() + ft_t.sum()):.1f} s of draws; phase 16 "
        f"waited {waited:.1f} s for them")
    tcfg = vtrain.TrainConfig()
    for name, fn, want in (
            ("scratch", scratch_fn, vtrain.synth_batch(
                tcfg, np.random.default_rng(SEED))),
            ("finetune", ft_fn, realgen.make_mixed_batch_fn(real_frac=0.25)(
                tcfg, np.random.default_rng(SEED)))):
        for k, v in want.items():
            if not np.array_equal(fn.arrays[k][0], v):
                raise AssertionError(f"{name} batch 0 {k} differs from the "
                                     f"trainer's own draw")

    # a. From scratch through the CLI entry point, the trainer's batch
    # source replayed, each step timed by CUDA events.
    events, loop = [], {}
    make_step, train_fn = vtrain.make_train_step, vtrain.train

    def timed_make(*args, **kw):
        step = make_step(*args, **kw)

        def timed(*a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            res = step(*a)
            e1.record()
            events.append((e0, e1))
            return res
        return timed

    def timed_train(*args, **kw):
        t0 = time.perf_counter()
        res = train_fn(*args, **kw)
        torch.cuda.synchronize()
        loop["s"] = time.perf_counter() - t0
        return res

    synth = vtrain.synth_batch
    vtrain.synth_batch, vtrain.make_train_step, vtrain.train = \
        scratch_fn, timed_make, timed_train
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        res = vtrain.main(["--steps", str(TRAIN_STEPS), "--seed", str(SEED),
                           "--eval-clips", "3",
                           "--out", os.path.join(tmp.name, "scratch_lm")])
    finally:
        vtrain.synth_batch, vtrain.make_train_step, vtrain.train = \
            synth, make_step, train_fn
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base_mem) / 1e9
    step_ms = [a.elapsed_time(b) for a, b in events]
    losses = res["losses"]
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    synth_ms = 1e3 * float(np.median(scratch_t))
    card_ms = float(np.median(step_ms))
    log(f"[train] from scratch, train.main --steps {TRAIN_STEPS} at full "
        f"width (batch {tcfg.batch_size}, bf16): {wall:.2f} s with its "
        f"evaluation; the loop {loop['s']:.2f} s = "
        f"{TRAIN_STEPS / loop['s']:.2f} steps/s, "
        f"{TRAIN_STEPS * tcfg.batch_size / loop['s']:.1f} samples/s "
        f"({card}); a step on the card by events median {card_ms:.2f} ms "
        f"(p90 {float(np.percentile(step_ms, 90)):.2f}); the host's batch "
        f"draw median {synth_ms:.1f} ms (so a trainer drawing its own "
        f"batches is host-bound at <= {1e3 / synth_ms:.2f} steps/s); peak "
        f"memory {peak:.3f} GB above the clip; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, mean of the first 20 {first:.4f}, of the last "
        f"20 {last:.4f} (ratio {last / first:.4f}, gate {TRAIN_FALL}); IoU "
        f"held-out {res['iou_held_out']:.4f}, train family "
        f"{res['iou_train']:.4f} (3 clips)")
    if len(scratch_fn.served) != TRAIN_STEPS or len(losses) != TRAIN_STEPS \
            or not np.isfinite(losses).all() or last >= TRAIN_FALL * first:
        raise AssertionError(f"training from scratch: {len(losses)} losses,"
                             f" first 20 {first}, last 20 {last}")
    out["s"]["scratch"] = wall
    out.update(steps_per_s=TRAIN_STEPS / loop["s"], step_ms=card_ms,
               synth_ms=synth_ms, peak_gb=peak, loss_ratio=last / first)

    # The card's busy share over TRAIN_PROFILED more steps of the loop
    # (upload, step), from the trained params.
    prof_fn, _ = replay_batches(os.path.join(tmp.name, "scratch.npz"))
    model, _, tx, _ = vtrain.init_state(tcfg, SEED, dev)
    step = vtrain.make_train_step(model, tx, tcfg)
    t_prof = {}

    def profiled():
        p, st = res["params"], tx.init(res["params"])
        t1 = time.perf_counter()
        for _ in range(TRAIN_PROFILED):
            b = vtrain.batch_to_device(prof_fn(tcfg, None), dev)
            p, st, _, _ = step(p, st, b)
        torch.cuda.synchronize()
        t_prof["s"] = time.perf_counter() - t1

    busy, top = device_profile(profiled, top=5)
    share = busy / (1e3 * t_prof["s"]) if busy is not None else math.nan
    log(f"[train] {TRAIN_PROFILED} steps under torch.profiler: the card busy "
        f"{busy} ms of {1e3 * t_prof['s']:.1f} ms (busy share {share:.3f}); "
        f"top kernels {[(k[:60], round(ms, 3), n) for k, ms, n in top]}")
    out["busy_share"] = share

    # b. The JAX package's fine-tune recipe, scored before and after on
    # the same clips; the checkpoint it writes reloads bit for bit.
    t0 = time.perf_counter()
    ft_cfg = vtrain.TrainConfig(learning_rate=1e-4, total_steps=FT_STEPS)
    base = lmk.load_params(device=dev)
    before = {ho: vtrain.evaluate_iou(base, ft_cfg, n_clips=FT_EVAL_CLIPS,
                                      held_out=ho, device=dev)
              for ho in (True, False)}
    make_mixed = realgen.make_mixed_batch_fn

    def replay_mixed(real_frac=0.25, real_cfg=None):
        if real_frac != 0.25 or real_cfg is not None:
            raise AssertionError(f"fine-tune mix {real_frac}, {real_cfg}")
        return ft_fn

    out["s"]["IoU before"] = time.perf_counter() - t0
    realgen.make_mixed_batch_fn = replay_mixed
    t0 = time.perf_counter()
    try:
        ft = vtrain.main(["--resume", lmk.default_weights_path(),
                          "--real-frac", "0.25", "--lr", "1e-4",
                          "--steps", str(FT_STEPS), "--seed", str(SEED),
                          "--eval-clips", str(FT_EVAL_CLIPS),
                          "--out", os.path.join(tmp.name, "landmarker_ft")])
    finally:
        realgen.make_mixed_batch_fn = make_mixed
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reloaded = lmk.load_params(ft["out"], device=dev)
    same = sorted(reloaded) == sorted(ft["params"]) and all(
        torch.equal(reloaded[k], ft["params"][k]) for k in reloaded)
    log(f"[train] fine-tune (--resume checkpoints/landmarker.npz "
        f"--real-frac 0.25 --lr 1e-4 --steps {FT_STEPS}): {wall:.2f} s with "
        f"its evaluation ({card}); loss {ft['losses'][0]:.4f} -> "
        f"{ft['losses'][-1]:.4f}; IoU on {FT_EVAL_CLIPS} clips held-out "
        f"{before[True]:.4f} -> {ft['iou_held_out']:.4f}, train family "
        f"{before[False]:.4f} -> {ft['iou_train']:.4f} (bar {FT_IOU_MIN}); "
        f"{os.path.basename(ft['out'])} reloaded bit for bit: {same}")
    if len(ft_fn.served) != FT_STEPS or not np.isfinite(ft["losses"]).all() \
            or ft["iou_held_out"] < FT_IOU_MIN or not same:
        raise AssertionError(f"fine-tune: held-out IoU {ft['iou_held_out']},"
                             f" reloaded equal {same}")
    out["s"]["fine-tune"] = wall
    out["iou"] = (before[True], ft["iou_held_out"])

    # c. The reloaded weights as the landmarker detector through the K2
    # measure on the flagship clip, phase 8c's gates; K2's counter from 0.
    det = lmk.make_detector(reloaded, lmk.LandmarkerConfig(), device=dev)
    learned_measure("fine-tuned landmarker", det, frames, truth_boxes, cfg,
                    LEARNED_IOU_MIN, out)

    # d. The dp×tp step on a (2, 2) mesh of 4 places of the card against
    # the unsharded step, from the same params and batch, in a float32
    # and the bf16 config; then the dry run with its step 1.
    t0 = time.perf_counter()
    batch = vtrain.batch_to_device(
        {k: v[0] for k, v in scratch_fn.arrays.items()}, dev)
    mesh = train_mesh(2, 2, devices=[dev] * 4)
    f32 = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, compute_dtype=torch.float32))
    for tag, c in (("float32", f32), ("bf16", tcfg)):
        model, params, tx, state = vtrain.init_state(c, SEED, dev)
        layout = vtrain.param_shardings(params, mesh)
        one = vtrain.make_train_step(model, tx, c)
        tp = vtrain.make_train_step(model, tx, c, mesh=mesh,
                                    params_example=params)
        placed = vtrain.shard_params(params, mesh)
        states = [tx.init(p) for p in placed]
        ms = {}
        for name, fn in (("unsharded", lambda: one(params, state, batch)),
                         ("dp x tp", lambda: tp(placed, states, batch))):
            fn()                                   # warm
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            got = fn()
            e1.record()
            torch.cuda.synchronize()
            ms[name] = (e0.elapsed_time(e1), got)
        p1, _, l1, _ = ms["unsharded"][1]
        p2, _, l2, _ = ms["dp x tp"][1]
        rel = abs(float(l2) - float(l1)) / float(l1)
        full = vtrain.unshard_params(p2, mesh, layout)
        n_off = sum(int(((full[k] - p1[k]).abs() > TP_PARAM_TOL).sum())
                    for k in p1)
        n_all = sum(v.numel() for v in p1.values())
        worst = max(float((full[k] - p1[k]).abs().max()) for k in p1)
        log(f"[train] dp x tp step, {tag}, (2, 2) mesh of 4 places of "
            f"{dev}, batch {c.batch_size}: loss {float(l2):.6f} against "
            f"{float(l1):.6f} unsharded (rel {rel:.3g}); params beyond "
            f"{TP_PARAM_TOL:g} on {n_off} of {n_all} elements (max "
            f"{worst:.3g}); a step {ms['dp x tp'][0]:.1f} ms against "
            f"{ms['unsharded'][0]:.1f} ms by events (second calls, {card})")
        # The params to one rule in both dtypes: AdamW's first step is
        # +-lr wherever a gradient is within rounding of zero, so a sign
        # flip (2 lr) may part the two on a few elements (11 in float32,
        # 733 in bf16 of 1,071,337 on an H100 80GB HBM3 at 700 W).
        tol = TP_F32_TOL if tag == "float32" else TP_BF16_TOL
        if rel > tol or n_off > 1e-3 * n_all \
                or worst > 2 * c.learning_rate + TP_PARAM_TOL:
            raise AssertionError(f"dp x tp {tag}: loss rel {rel}, {n_off} "
                                 f"of {n_all} off, max {worst}")
    out["s"]["dp x tp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line = entry.dryrun_multichip(4)
    loss = float(line.split("loss=")[1].split(";")[0])
    out["s"]["dry run"] = time.perf_counter() - t0
    log(f"[train] dryrun_multichip(4) ran its step 1, loss {loss:.4f}")
    if not math.isfinite(loss):
        raise AssertionError(f"dry run's train step loss {loss}")
    tmp.cleanup()
    out["s"]["phase"] = time.perf_counter() - t_phase
    log(f"[train] check times ({card}): " + ", ".join(
        f"{k} {v:.2f} s" for k, v in out["s"].items()))
    return out


def check_roi_means(fn, tag: str, cases) -> float:
    """K2's or K3's entry ``fn`` on each ``(name, frames, rois, kwargs)``
    case, on the instance the plan takes and on the generic one: means and
    counts equal to the plain version's bit for bit, each instance's launch
    counter moved.  Returns the largest |difference| (0)."""
    import torch
    from vhr_tpu_torch.ops.reduce import roi_channel_means

    err = 0.0
    for name, x, rois, kw in cases:
        want = roi_channel_means(x, rois, **kw)
        for instance in (None, "generic"):
            counts = (counter("k2.vec"), counter("k2.generic"))
            got = fn(x, rois, instance=instance, **kw)
            torch.cuda.synchronize()
            took = "vector" if counter("k2.vec") > counts[0] else "generic"
            if instance is not None and took != instance:
                raise AssertionError(f"{tag} {name}: {instance} not launched")
            err = max(err, compare(f"{tag} {name} ({took})", got, want))
            same_bits(f"{tag} {name} ({took})", got, want)
            log(f"[check] {tag} {took} instance == plain bit for bit on "
                f"{name} ROIs, {tuple(x.shape)}")
    return err


def pool_rois(frames, cfg):
    """The cheek ROIs the skin-detector pool tick gives K2 for these slot
    frames (a tick in which every slot detects)."""
    import torch
    from vhr_tpu_torch.models import skin_detector
    from vhr_tpu_torch.ops import roi

    _, h, w, _ = frames.shape
    boxes, ok = skin_detector.detect_faces(frames)
    rois = roi.measurement_roi(boxes.to(torch.int32), cfg.roi, w, h,
                               cfg.roi_site)
    return torch.where(ok[:, None], rois, 0).to(torch.int32)


def same_bits(name: str, got, want) -> None:
    """Every tensor of ``got`` equal to its counterpart, floats included."""
    import torch

    for i, (g, w_) in enumerate(zip(got, want)):
        if not torch.equal(g, w_):
            bad = (g != w_).nonzero()[:5].tolist()
            raise AssertionError(f"{name}: output {i} differs at {bad}")


def check_k4(dev) -> float:
    """K4 against its plain version at 64 slots of 720p; max |err|.

    The carries: fresh slots, spent budgets, tracked faces, random boxes, a
    tracked box whose cheek ROI straddles the chunk boundary at row 256
    while ``gate_margin=0.5`` leaves the last chunk out, and a box that
    runs over the frame's right and bottom edge, so that its ROI is
    clipped.  With ``ROIConfig(cheek_bottom=2.0)`` and ``gate_margin=0.1``
    the straddling box's ROI runs on into a chunk that the gate leaves
    out.  Every output must equal the plain version's, the means too: both
    sum exactly and divide once in float32."""
    import torch
    from vhr_tpu_torch.config import ROIConfig
    from vhr_tpu_torch.ops import fused_cuda

    subj = Subjects(dev, SLOTS, PH, PW, SEED + 2)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    frames = subj.frames(range(SLOTS), torch.randint(
        0, 900, (SLOTS,), generator=gen, device=dev).tolist())

    def r(lo, hi):
        return torch.randint(lo, hi, (SLOTS,), generator=gen, device=dev)

    def box(*v):
        return torch.tensor(v, device=dev, dtype=torch.int32)

    x1, y1 = r(0, PW // 2), r(0, PH // 2)
    carry = torch.stack([x1, y1, x1 + r(PW // 16, PW // 2),
                         y1 + r(PH // 16, PH // 2), r(0, 16), r(0, 2)],
                        1).to(torch.int32)
    q = SLOTS // 8
    carry[:q] = 0                                       # fresh slots
    carry[q:2 * q, 4] = 0                               # spent budgets
    carry[q:3 * q, 5] = 1
    carry[2 * q:3 * q, :4] = box(                       # tracked faces
        int(0.34 * PW), int(0.19 * PH), int(0.66 * PW), int(0.71 * PH))
    # ROI rows 220-295 across the chunk boundary at 256 (row_block=128).
    carry[3 * q:4 * q] = box(400, 100, 800, 400, 15, 1)
    # ROI columns 975-1325 and rows 660-760: clipped at 1280 and 720.
    carry[4 * q:5 * q] = box(900, 500, 1400, 900, 15, 1)
    phase = r(0, 1000).to(torch.int32)
    sets = [dict(detect_row_pool=pool, detect_every=every, gate_margin=gate)
            for pool in (1, 8) for every in (1, 4) for gate in (None, 0.5)]
    sets += [dict(detect_row_pool=pool, gate_margin=0.1,
                  roi=ROIConfig(cheek_bottom=2.0)) for pool in (1, 8)]
    err = 0.0
    for kw in sets:
        got, got_c = fused_cuda.fused_detect_roi_slots(
            frames, carry, phase, **kw)
        want, want_c = fused_cuda.fused_detect_roi_slots_plain(
            frames, carry, phase, **kw)
        torch.cuda.synchronize()
        same_bits(f"K4 {kw}", tuple(got) + (got_c,), tuple(want) + (want_c,))
        err = max(err, compare(f"K4 {kw}", tuple(got) + (got_c,),
                               tuple(want) + (want_c,)))
        shown = {k: (v if k != "roi" else "cheek_bottom=2.0")
                 for k, v in kw.items()}
        log(f"[check] K4 == plain {shown}: det_valid "
            f"{int(got.det_valid.sum())}/{SLOTS}, roi_valid "
            f"{int(got.roi_valid.sum())}/{SLOTS}")
    return err


CHURN, CHURN_AT = 3, 20


def pool_ticks(pool, subj, ticks: int):
    """Drive ``pool`` through ``ticks`` ticks of the serving phase's
    schedule: eight groups of slots attach 4 ticks apart (slots fill in
    order), slot 5 skips every tenth tick, and at tick CHURN_AT the client
    of slot CHURN leaves and a new one takes the slot.  Yields ``(t, send,
    frames, outs, local)``: the slots that sent a frame, their frames, the
    tick's outputs and each client's count of frames sent."""
    attach_at = [s * 8 // SLOTS * 4 for s in range(SLOTS)]
    skipper = 5
    local = [0] * SLOTS                   # frames each client has sent
    for t in range(ticks):
        for s in range(SLOTS):
            if t == attach_at[s] and pool.attach() != s:
                raise AssertionError("slots attach in order")
        if t == CHURN_AT:                 # a client leaves, a new one joins
            pool.detach(CHURN)
            if pool.attach() != CHURN:
                raise AssertionError("the freed slot is reattached")
            local[CHURN] = 0
        send = [s for s in range(SLOTS) if t >= attach_at[s]
                and not (s == skipper and t % 10 == 3)]
        frames = subj.frames(send, [local[s] for s in send])
        outs = pool.tick({s: frames[j] for j, s in enumerate(send)})
        for s in send:
            local[s] += 1
        yield t, send, frames, outs, local


def run_pool(dev, use_fused: bool, method: str = "green",
             record: int = 0) -> dict:
    """Drive a 64-slot pool of 720p subjects through TICKS ticks; check
    every slot's BPM against its truth, two slots against the single-stream
    live step, and full rings against scipy's Welch (``"green"``) or
    against the port's method on the CPU from the same rings.  Returns the
    pool, every slot's next frame (on the card), the BPM errors and the
    outputs of the first ``record`` ticks."""
    import numpy as np
    import scipy.signal
    import torch
    from vhr_tpu_torch import serving
    from vhr_tpu_torch.pipeline import live

    cfg = live.LiveConfig(fps=FPS, use_fused=use_fused, method=method)
    pool = serving.BpmServer(cfg, n_slots=SLOTS)
    subj = Subjects(dev, SLOTS, PH, PW, SEED + 4)
    chosen = (0, SLOTS // 3)      # an early and a late attacher
    singles = {s: live.init_state(cfg, dev) for s in chosen}
    hist = {s: [] for s in range(SLOTS)}  # (filtered, face_valid) per frame
    last = {}
    recorded = []             # the first `record` ticks' outputs
    agree = [0, 0]            # ticks whose BPM and choice equal the step's
    for t, send, frames, outs, local in pool_ticks(pool, subj, TICKS):
        if t == CHURN_AT:
            hist[CHURN] = []
        if t < record:
            recorded.append(outs)
        for j, s in enumerate(send):
            o = outs[s]
            hist[s].append((float(o.green_filtered), bool(o.face_valid)))
            last[s] = o
            if s in chosen:
                singles[s], ref = live.step(singles[s], frames[j], cfg)
                same = (bool(ref.face_valid) == bool(o.face_valid)
                        and ref.box.tolist() == o.box.tolist()
                        and abs(float(ref.green_raw)
                                - float(o.green_raw)) <= 1e-5)
                if not same:
                    raise AssertionError(
                        f"slot {s} tick {t}: pool {o} != single step {ref}")
                if bool(ref.bpm_valid) or bool(o.bpm_valid):
                    agree[1] += 1
                    agree[0] += (bool(ref.bpm_valid) == bool(o.bpm_valid)
                                 and float(ref.bpm) == float(o.bpm)
                                 and int(ref.choice) == int(o.choice))
    truth = subj.bpm.tolist()
    errs = [abs(float(last[s].bpm) - truth[s]) for s in range(SLOTS)]
    valid = [bool(last[s].bpm_valid) for s in range(SLOTS)]
    if not all(valid) or max(errs) > BPM_TOL:
        raise AssertionError(f"pool BPM: valid {valid}, |err| {errs}")
    if method != "green" and agree[0] < 0.99 * agree[1]:
        raise AssertionError(f"slots {chosen}: BPM, validity and choice "
                             f"equal the single step on {agree[0]} of "
                             f"{agree[1]} ticks")
    snap = pool.snapshot()
    count = snap["state.count"]
    full = [s for s in range(SLOTS) if count[s] >= cfg.ring_len]
    if not full:
        raise AssertionError("no slot filled its ring")
    form = ("fused" if use_fused else "skin") + (
        "" if method == "green" else f" {method}")
    if method == "green":
        band = (cfg.band.low_hz, cfg.band.high_hz)
        nper = int(cfg.fps * cfg.welch_segment_seconds)
        for s in full:
            x = np.array([f for f, v in hist[s] if v][-cfg.ring_len:])
            f, p = scipy.signal.welch(x, fs=cfg.fps, window="hann",
                                      nperseg=nper, noverlap=nper // 2)
            inb = (f >= band[0]) & (f <= band[1])
            ref = float(f[inb][np.argmax(p[inb])] * 60.0)
            if abs(float(last[s].bpm) - ref) >= 1e-3:
                raise AssertionError(f"slot {s}: pool BPM "
                                     f"{float(last[s].bpm)} != scipy welch "
                                     f"{ref}")
        ring_check = "full rings == scipy welch peak"
    else:
        # The same rings through the port's method on the CPU.
        rings = [torch.as_tensor(snap[f"state.{k}"]) for k in
                 ("ring_raw", "ring_bgr", "ring_filt", "count")]
        bpm, ok, choice = live._method_bpm(cfg, *rings)
        got = np.array([[float(last[s].bpm), bool(last[s].bpm_valid),
                         int(last[s].choice)] for s in range(SLOTS)])
        want = np.stack([bpm.numpy(), ok.numpy(), choice.numpy()], 1)
        same = (got == want).all(1)
        if same.mean() < 0.99:
            raise AssertionError(f"{method} pool: card against CPU equal "
                                 f"on {int(same.sum())} of {SLOTS} slots")
        picked = np.bincount(got[:, 2].astype(int),
                             minlength=len(cfg.adaptive_methods)).tolist()
        ring_check = (f"the rings' BPM, validity and choice on the CPU == "
                      f"the card's on {int(same.sum())}/{SLOTS} slots; "
                      f"last ticks' choices {picked}")
    log(f"[pool {form}] {SLOTS} slots x {TICKS} ticks at {PW}x{PH}: all "
        f"bpm_valid, |BPM - truth| max {max(errs):.3f} mean "
        f"{statistics.mean(errs):.3f}; slots {list(chosen)} == single "
        f"step (BPM, validity and choice on {agree[0]}/{agree[1]} ticks); "
        f"{len(full)} {ring_check}")
    return dict(pool=pool, frames=subj.frames(range(SLOTS), local),
                errs=errs, recorded=recorded)


def run_server(dev) -> dict:
    """Three clients (2 TCP, 1 WebSocket) against a 4-slot fused 720p pool
    behind ``serve_forever``."""
    import numpy as np
    from vhr_tpu_torch import serving
    from vhr_tpu_torch.pipeline import live

    pool = serving.BpmServer(live.LiveConfig(fps=FPS, use_fused=True),
                             n_slots=4)
    subj = Subjects(dev, 3, PH, PW, SEED + 5)
    n = SERVE_FRAMES + SERVE_RTT
    clips = [np.stack([subj.frames([i], [k])[0].cpu().numpy()
                       for k in range(n)]) for i in range(3)]
    srv = serving.serve_forever("127.0.0.1", 0, pool, frame_shape=(PH, PW))
    port = srv.server_address[1]
    results, errors = {}, []

    def client(i, cls):
        try:
            c = cls("127.0.0.1", port)
            for f in clips[i][:SERVE_FRAMES]:
                c.send(f)
            lines = [c.recv() for _ in range(SERVE_FRAMES)]
            rtt = []
            for f in clips[i][SERVE_FRAMES:]:
                t0 = time.perf_counter()
                c.send(f)
                lines.append(c.recv())
                rtt.append((time.perf_counter() - t0) * 1e3)
            c.close()
            results[i] = (lines, rtt)
        except Exception as e:            # reported below, fails the phase
            errors.append(f"client {i}: {e!r}")

    kinds = [serving.BpmClient, serving.BpmClient, serving.WsBpmClient]
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i, k))
               for i, k in enumerate(kinds)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    srv.shutdown()
    srv.server_close()
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"server clients failed: {errors}")
    truth = subj.bpm.tolist()
    rtts = {}
    for i, (lines, rtt) in results.items():
        if [ln.get("seq") for ln in lines] != list(range(n)):
            raise AssertionError(f"client {i}: replies out of order")
        end = lines[SERVE_FRAMES - 1]
        if not end["bpm_valid"] or abs(end["bpm"] - truth[i]) > BPM_TOL:
            raise AssertionError(f"client {i}: {end} vs truth {truth[i]}")
        rtts[kinds[i].__name__ + str(i)] = statistics.median(rtt)
    log(f"[server] 3 clients x {SERVE_FRAMES} frames of {PW}x{PH} in "
        f"{wall:.2f} s ({3 * SERVE_FRAMES / wall:.1f} frames/s through the "
        f"sockets); last lines bpm_valid within {BPM_TOL} BPM; median "
        f"one-frame round trip ms {rtts}")
    return dict(wall=wall, rtt=rtts)


def run_analysis(dev, frames, card: str) -> dict:
    """The analysis harness through its CLI entry point,
    ``analysis.main.main``, on the card: the flagship clip's first
    ANALYSIS_T frames as mp4v with a truth CSV, swept over
    ``spatial_resolution`` with ``green_avg`` and ``evm`` (K6), then over
    ``colour_noise`` with ``green_avg``; then the MediaPipe phase's drawn
    face, its first ANALYSIS_T frames, ``original`` with ``green_avg``
    under ``--detector mediapipe`` (K5).  Counters from 0 before each
    sweep, read after."""
    import numpy as np
    import torch
    from vhr_tpu_torch.analysis import context
    from vhr_tpu_torch.analysis import main as amain
    from vhr_tpu_torch.analysis.degradation import (colour_noise,
                                                    spatial_resolution)
    from vhr_tpu_torch.analysis.measurement import green_avg
    from vhr_tpu_torch.config import PipelineConfig
    from vhr_tpu_torch.io import video as vio
    from vhr_tpu_torch.pipeline import offline

    h, w = frames.shape[1:3]
    out = {"launches": {}}
    saved = {k: os.environ.get(k) for k in ("VHR_RESULTS_DIR",
                                            "VHR_CACHE_DIR")}
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    results = os.path.join(tmp, "results")
    os.environ["VHR_RESULTS_DIR"] = results
    os.environ["VHR_CACHE_DIR"] = os.path.join(tmp, "cache")

    def write(name, clip):
        """``clip`` as ``<name>.mp4`` (mp4v) and ``<name>.csv`` (the truth
        every 0.5 s) in ``tmp``."""
        t0 = time.perf_counter()
        vio.write_video(clip.cpu().numpy(), os.path.join(tmp, f"{name}.mp4"),
                        FPS)
        with open(os.path.join(tmp, f"{name}.csv"), "w") as f:
            f.write("timestamp,heart_rate\n" + "".join(
                f"{0.5 * i},{TRUTH_BPM}\n"
                for i in range(int(2 * clip.shape[0] / FPS) + 1)))
        log(f"[analysis] {name} clip {tuple(clip.shape)} written as mp4v in "
            f"{time.perf_counter() - t0:.1f} s")

    def sweep(name, n, argv, kernel, key=None):
        """``main`` on ``<name>.mp4`` of ``n`` frames, counters from 0: the
        launches (``kernel``'s at least one, where the sweep's path has
        one), every level's ``.npy`` against ``summary.json``, the
        stage times, kept under ``key`` (default ``name``)."""
        reset_counters("k6.launches", "k5.launches")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = amain.main(["--video", os.path.join(tmp, f"{name}.mp4"),
                         "--results-dir", results, "--device", "cuda"]
                        + argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        base = os.path.join(results, name)
        with open(os.path.join(base, "summary.json")) as f:
            summary = json.load(f)
        launches = {"K6": counter("k6.launches"), "K5": counter("k5.launches")}
        log(f"[analysis] main {' '.join(argv)}: exit {rc} in {wall:.1f} s; "
            f"kernel launches {launches}")
        if rc != 0 or (kernel and launches[kernel] < 1):
            raise AssertionError(f"analysis sweep {argv}: exit {rc}, "
                                 f"launches {launches}")
        for deg, by_m in summary["rows"].items():
            for m, by_lbl in by_m.items():
                for lbl, rows_n in by_lbl.items():
                    arr = np.load(os.path.join(base, "measurements", m, deg,
                                               f"{lbl}.npy"))
                    if arr.shape != (rows_n, 2) or not np.isfinite(arr).all():
                        raise AssertionError(f"{m}/{deg}/{lbl}.npy: "
                                             f"{arr.shape}, {rows_n} rows")
        for stage, v in summary["stage_timings"].items():
            rate = ""
            if stage.startswith("measure:"):
                rate = (f", {v['count'] * n / v['total_s']:.1f} frames/s "
                        f"over {v['count']} levels")
            log(f"[analysis] {name} {stage}: {v['total_s']:.3f} s, "
                f"{v['count']} calls, {v['mean_ms']:.1f} ms a call{rate} "
                f"({card})")
        if kernel:
            out["launches"][kernel] = launches[kernel]
        out[key or name] = dict(wall=wall, stages=summary["stage_timings"])
        return base, summary

    def median_bpm(base, m, deg, lbl):
        """A level's rows and the median of their BPM (every row the
        measure returns is past its acquisition)."""
        arr = np.load(os.path.join(base, "measurements", m, deg,
                                   f"{lbl}.npy"))
        return arr, float(np.median(arr[:, 1])) if len(arr) else math.nan

    try:
        log(f"[analysis] the sweep clip is the flagship clip's first "
            f"{ANALYSIS_T} of {frames.shape[0]} frames at full width (the "
            f"phase's time budget)")
        clip = frames[:ANALYSIS_T]
        write("flagship", clip)
        base, summary = sweep(
            "flagship", ANALYSIS_T,
            ["--degradation", "spatial_resolution",
             "--methods", "green_avg", "evm"], "K6")
        levels = {d: list(by_m["green_avg"])
                  for d, by_m in summary["rows"].items()}
        want = {"spatial_resolution": [f"{h}p"] + [
            f"{th}p" for th in spatial_resolution.TARGET_HEIGHTS if th < h]}
        if levels != want:
            raise AssertionError(f"levels {levels}, expected {want}")
        for deg in want:
            log(f"[analysis] {deg} rows and median BPM: " + ", ".join(
                f"{m} {lbl} {len(a)} {med:.3f}"
                for m in ("green_avg", "evm") for lbl in want[deg]
                for a, med in [median_bpm(base, m, deg, lbl)]))

        # The control levels hold the pulse: green_avg's median and the EVM
        # measure's MAE against the truth.
        for deg, lbl in (("spatial_resolution", f"{h}p"),):
            g, med = median_bpm(base, "green_avg", deg, lbl)
            e, _ = median_bpm(base, "evm", deg, lbl)
            mae = float(np.abs(e[:, 1] - TRUTH_BPM).mean()) if len(e) \
                else math.inf
            log(f"[analysis] control {deg}/{lbl}: green_avg {len(g)} rows, "
                f"median {med:.3f} BPM; evm {len(e)} rows, MAE {mae:.4f} vs "
                f"{TRUTH_BPM:g} BPM")
            if not abs(med - TRUTH_BPM) <= BPM_TOL or mae > EVM_MAE_TOL:
                raise AssertionError(f"control level {deg}/{lbl}: median "
                                     f"{med}, EVM MAE {mae}")

        # The original level's green_avg rows are the library measure's on
        # the same decoded frames on the card.
        decoded, fps = vio.read_video(os.path.join(tmp, "flagship.mp4"))
        cfg = PipelineConfig(window_seconds=green_avg.WINDOW_SIZE,
                             acquisition_seconds=green_avg.ACQUISITION_TIME)
        lib = offline.to_measurement_array(*offline.measure_green_avg(
            torch.as_tensor(decoded, device=dev), fps, cfg))
        plug, _ = median_bpm(base, "green_avg", "spatial_resolution",
                             f"{h}p")
        if lib.shape != plug.shape or not np.array_equal(lib, plug):
            raise AssertionError(f"green_avg plugin != measure_green_avg: "
                                 f"{plug.shape} vs {lib.shape}")
        log(f"[analysis] green_avg plugin == offline.measure_green_avg on "
            f"the decoded frames on the card: {len(lib)} rows equal")

        # One chunk of the 720p level's resize on the card against the CPU.
        th = spatial_resolution.TARGET_HEIGHTS[0]
        tw = int(round(w * th / h))
        tw -= tw % 2
        chunk = decoded[:ANALYSIS_RESIZE_T]
        got = spatial_resolution._resize_op(th, tw)(chunk)
        context.set_device("cpu")
        try:
            ref = spatial_resolution._resize_op(th, tw)(chunk)
        finally:
            context.set_device(None)
        diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        log(f"[analysis] resize to {tw}x{th} of {len(chunk)} frames, card "
            f"vs CPU: max |diff| {int(diff.max())} u8, equal on "
            f"{float((diff == 0).mean()):.6f} of the values")
        if got.shape != (len(chunk), th, tw, 3) or diff.max() > 1:
            raise AssertionError(f"resize card vs CPU: {got.shape}, "
                                 f"{int(diff.max())} u8")

        del decoded

        # colour_noise through the sweep on the same clip, green_avg alone
        # (the plain form: no kernel on its path); the noise is drawn and
        # added on the card.  The control level holds the pulse.
        base, summary = sweep(
            "flagship", ANALYSIS_T,
            ["--degradation", "colour_noise", "--methods", "green_avg"],
            None, key="flagship colour_noise")
        want = ["0std"] + [f"{sd}std" for sd in colour_noise.NOISE_LEVELS]
        levels = {d: list(by_m["green_avg"])
                  for d, by_m in summary["rows"].items()}
        if levels != {"colour_noise": want}:
            raise AssertionError(f"levels {levels}, expected {want}")
        log("[analysis] colour_noise rows and median BPM: " + ", ".join(
            f"green_avg {lbl} {len(a)} {med:.3f}" for lbl in want
            for a, med in [median_bpm(base, "green_avg", "colour_noise",
                                      lbl)]))
        g, med = median_bpm(base, "green_avg", "colour_noise", "0std")
        log(f"[analysis] control colour_noise/0std: green_avg {len(g)} rows, "
            f"median {med:.3f} BPM")
        if not abs(med - TRUTH_BPM) <= BPM_TOL:
            raise AssertionError(f"control level colour_noise/0std: median "
                                 f"{med}")

        # The MediaPipe detector through the sweep (K5), on the MediaPipe
        # phase's clip cut to ANALYSIS_T frames, as the flagship's.
        face, _ = make_face_clip(dev, ANALYSIS_T, h, w, seed=SEED + 8)
        write("face", face)
        try:
            base, _ = sweep("face", face.shape[0],
                            ["--degradation", "original", "--methods",
                             "green_avg", "--detector", "mediapipe"], "K5")
        finally:
            context.set_detector("skin")
        del face
        g, med = median_bpm(base, "green_avg", "original", "original")
        log(f"[analysis] face/original green_avg --detector mediapipe: "
            f"{len(g)} rows, median {med:.3f} BPM")
        if not abs(med - TRUTH_BPM) <= BPM_TOL:
            raise AssertionError(f"MediaPipe sweep: median {med}")
    finally:
        tmp_dir.cleanup()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def make_duo(dev, t: int, h: int, w: int, bpms=DUO_BPM, seed: int = SEED,
             chunk: int = 64):
    """``(t, h, w, 3)`` u8 BGR clip of two side-by-side faces made on
    ``dev`` from a seed (``utils.synth.synthesize_multi``'s geometry: skin
    ellipses at x 0.25 and 0.72 of the width), each with its own green
    pulse rate ``bpms``, a small sway and 0-7 u8 of sensor noise."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = torch.empty((t, h, w, 3), dtype=torch.uint8, device=dev)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    bg = torch.tensor([60.0, 60.0, 60.0], device=dev)
    skin = torch.tensor([105.0, 135.0, 180.0], device=dev)
    for s in range(0, t, chunk):
        n = min(chunk, t - s)
        ts = torch.arange(s, s + n, device=dev, dtype=torch.float32) / FPS
        img = bg.expand(n, h, w, 3).clone()
        for (fx, fy), bpm in zip(((0.25, 0.45), (0.72, 0.5)), bpms):
            cx = fx * w + 3.0 * torch.sin(2 * math.pi * 0.1 * ts + fx)
            face = (((xx - cx[:, None, None]) / (0.12 * w)) ** 2
                    + ((yy - fy * h) / (0.18 * h)) ** 2) <= 1.0
            color = skin.expand(n, 3).clone()
            color[:, 1] += 2.0 * torch.sin(2 * math.pi * bpm / 60.0 * ts)
            img = torch.where(face[..., None], color[:, None, None, :], img)
        img += torch.randint(0, 8, (n, h, w, 3), generator=gen,
                             device=dev).to(torch.float32)
        frames[s:s + n] = img.clamp(0, 255).to(torch.uint8)
    return frames


def run_app_slice(dev, frames, card: str) -> dict:
    """The apps and the multi-face path on the card (phase 15): the video
    app single-face at 1080p (skin, then ``--detector mediapipe``) and with
    ``--faces 2`` at 720p; ``LivePipeline(k_faces=2)`` against the
    sequential ``make_step_multi`` with sync debugging; the K=2 pool
    against ``step_multi``; ``evm_magnify`` at 1080p; ``bpp --json`` against
    numpy; ``validation.main`` in a temporary directory; ``entry()``.
    Counters from 0 before each path, read after.  Returns the launches
    and each check's time."""
    import contextlib
    import io

    import cv2
    import numpy as np
    import torch
    from vhr_tpu_torch import entry as tentry
    from vhr_tpu_torch import serving, validation
    from vhr_tpu_torch.apps import bpp, evm_magnify, rppg_video
    from vhr_tpu_torch.config import PipelineConfig
    from vhr_tpu_torch.io import video as vio
    from vhr_tpu_torch.ops import fused_cuda
    from vhr_tpu_torch.pipeline import live, offline

    out = {"launches": {}, "s": {}}

    def call(fn, argv):
        """``fn(argv)`` with its standard output captured: (exit, lines,
        seconds)."""
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
        return rc, buf.getvalue().splitlines(), time.perf_counter() - t0

    def filter_bpms(lines):
        """The video app's ``BPM Butterworth: a | Cheby2: b | FIR: c``."""
        line = next((ln for ln in lines if ln.startswith("BPM ")), "")
        return [float(p.split(": ")[1]) for p in line.split(" | ")] \
            if line else []

    def captured(name, argv):
        """``rppg_video.main(argv)`` with the results of its
        ``rppg_video.<name>`` call kept: (exit, lines, seconds, results)."""
        kept, inner = [], getattr(rppg_video, name)

        def keep(*a, **kw):
            kept.append(inner(*a, **kw))
            return kept[-1]

        setattr(rppg_video, name, keep)
        try:
            rc, lines, wall = call(rppg_video.main, argv)
        finally:
            setattr(rppg_video, name, inner)
        return rc, lines, wall, kept[0] if kept else None

    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    try:
        # The video app, single face, on a 1080p MJPG cut of the flagship
        # clip (10.7 s: the 10 s window fills).
        t0 = time.perf_counter()
        cut = frames[:APP_T].cpu().numpy()
        flag = os.path.join(tmp, "flagship.avi")
        vio.write_video(cut, flag, FPS, fourcc="MJPG")
        log(f"[app] flagship cut {cut.shape} written as MJPG in "
            f"{time.perf_counter() - t0:.1f} s")
        rc, lines, wall, res = captured("analyze", [
            flag, "--out-dir", os.path.join(tmp, "video"), "--live-panels"])
        bpms = filter_bpms(lines)
        n_out = vio.video_metadata(
            os.path.join(tmp, "video", "annotated.mp4"))[3]
        log(f"[app] rppg_video main --live-panels: exit {rc} in {wall:.2f} s "
            f"({APP_T / wall:.1f} frames/s with decode, analysis, render and "
            f"encode); annotated.mp4 {n_out} frames; last valid BPM "
            f"Butterworth, Cheby2, FIR {bpms}; {lines[-1] if lines else ''}")
        if rc != 0 or n_out != APP_T or len(bpms) != 3 \
                or any(abs(b - TRUTH_BPM) > BPM_TOL for b in bpms):
            raise AssertionError(f"rppg_video: exit {rc}, {n_out} frames, "
                                 f"BPM {bpms}")
        out["s"]["rppg_video"] = wall
        decoded = res["frames"]
        trace = offline.extract_signals(torch.as_tensor(decoded, device=dev))
        same = np.array_equal(res["green"], trace.bgr[:, 1].cpu().numpy()) \
            and np.array_equal(res["valid"], trace.valid.cpu().numpy())
        t0 = time.perf_counter()
        panels = rppg_video.live_panel_data(res)
        t_pan = time.perf_counter() - t0
        med = [float(np.median(b)) for b in panels[4:]]
        log(f"[app] its analyze: green and valid == offline.extract_signals "
            f"on the decoded frames: {same}; live_panel_data {t_pan:.3f} s "
            f"for {panels[2].shape[0]} windows, panel BPM medians "
            f"Butterworth {med[0]:.3f}, Chebyshev II {med[1]:.3f}")
        if not same or any(abs(m - TRUTH_BPM) > BPM_TOL for m in med):
            raise AssertionError(f"analyze: trace equal {same}, panel "
                                 f"medians {med}")
        del trace, res

        # bpp --json on the same MJPG against numpy on cv2's gray frames.
        rc, lines, wall = call(bpp.main, [flag, "--json"])
        stats = json.loads(lines[-1])
        ent, var, nsr = [], [], []
        for f in decoded:                   # cv2's decode of the file
            g = cv2.cvtColor(f, cv2.COLOR_BGR2GRAY).astype(np.float64)
            p = np.bincount(g.astype(np.int64).ravel(),
                            minlength=256) / g.size
            ent.append(-np.sum(p * np.log2(p + 1e-6)))
            var.append(g.var())
            nsr.append(g.std() / g.mean() if g.mean() else 0.0)
        del decoded
        ref = dict(avg_entropy=np.mean(ent), avg_noise_variance=np.mean(var),
                   avg_nsr=np.mean(nsr))
        rel = {k: abs(stats[k] - v) / abs(v) for k, v in ref.items()}
        log(f"[app] bpp --json: exit {rc} in {wall:.2f} s; {stats}; "
            f"relative error against numpy {rel}")
        if rc != 0 or stats["frames"] != APP_T or len(ent) != APP_T \
                or max(rel.values()) > 1e-5:
            raise AssertionError(f"bpp: exit {rc}, {stats}, {rel}")
        out["s"]["bpp"] = wall

        # The video app under --detector mediapipe (K5) on the MediaPipe
        # phase's drawn face, cut to APP_T frames.
        face, _ = make_face_clip(dev, APP_T, H, W, seed=SEED + 9)
        fpath = os.path.join(tmp, "face.avi")
        vio.write_video(face.cpu().numpy(), fpath, FPS, fourcc="MJPG")
        del face
        reset_counters("k5.launches")
        rc, lines, wall = call(rppg_video.main, [
            fpath, "--out-dir", os.path.join(tmp, "face"), "--detector",
            "mediapipe"])
        torch.cuda.synchronize()
        k5 = out["launches"]["K5"] = counter("k5.launches")
        bpms = filter_bpms(lines)
        log(f"[app] rppg_video --detector mediapipe: exit {rc} in "
            f"{wall:.2f} s; K5 launches {k5}; last valid BPM "
            f"{bpms}")
        if rc != 0 or k5 < 1 or len(bpms) != 3 \
                or any(abs(b - TRUTH_BPM) > BPM_TOL for b in bpms):
            raise AssertionError(f"rppg_video mediapipe: exit {rc}, K5 "
                                 f"{k5}, BPM {bpms}")
        out["s"]["rppg_video mediapipe"] = wall

        # Two faces at 720p: the video app with --faces 2, LivePipeline and
        # the pool with k_faces=2.
        t0 = time.perf_counter()
        duo = make_duo(dev, DUO_POOL_T, PH, PW)
        torch.cuda.synchronize()
        dpath = os.path.join(tmp, "duo.avi")
        vio.write_video(duo[:DUO_APP_T].cpu().numpy(), dpath, FPS,
                        fourcc="MJPG")
        log(f"[app] two-face clip {tuple(duo.shape)} made on the card, its "
            f"first {DUO_APP_T} frames written as MJPG in "
            f"{time.perf_counter() - t0:.1f} s")
        rc, lines, wall, res = captured("analyze_multi", [
            dpath, "--out-dir", os.path.join(tmp, "duo"), "--faces", "2"])
        faces = dict(ln.split(" BPM: ") for ln in lines
                     if ln.startswith("face"))
        b, v = res["boxes"], res["valid"]
        ordered = bool((b[v.all(1)][:, 0, 2] < b[v.all(1)][:, 1, 0]).all())
        log(f"[app] rppg_video --faces 2 on {DUO_APP_T} frames of "
            f"{PW}x{PH}: exit {rc} in {wall:.2f} s; {faces}; both faces "
            f"valid on {int(v.all(1).sum())} frames, boxes in x-order "
            f"{ordered}")
        if rc != 0 or set(faces) != {"face0", "face1"} or not ordered \
                or any(abs(float(faces[f"face{k}"]) - DUO_BPM[k]) > BPM_TOL
                       for k in range(2)):
            raise AssertionError(f"rppg_video --faces 2: exit {rc}, "
                                 f"{faces}, x-order {ordered}")
        out["s"]["rppg_video --faces 2"] = wall
        del res

        # LivePipeline(k_faces=2) against the sequential step, bit for bit.
        cfg = live.LiveConfig(fps=FPS)
        host = duo[:DUO_LIVE_T].cpu().numpy()
        t0 = time.perf_counter()
        pipe = live.LivePipeline(cfg, k_faces=2)
        got = []
        for f in host:
            o = pipe.submit(f)
            if o is not None:
                got.append(o)
        got.append(pipe.flush())
        wall = time.perf_counter() - t0
        step = live.make_step_multi(cfg, 2)
        st = live.init_state_multi(cfg, 2, dev)
        same = True
        for f, o in zip(duo[:DUO_LIVE_T], got):
            st, r = step(st, f)
            r = live.unpack_output(live.pack_output(r).cpu().numpy())
            same &= all(np.array_equal(getattr(o, k), getattr(r, k))
                        for k in o._fields)
        last = got[-1]
        log(f"[app] LivePipeline(k_faces=2): {len(got)} outputs in "
            f"{wall:.2f} s ({DUO_LIVE_T / wall:.1f} frames/s); == sequential "
            f"make_step_multi: {same}; last BPM {last.bpm.tolist()} valid "
            f"{last.bpm_valid.tolist()}")
        if len(got) != DUO_LIVE_T or not same or not last.bpm_valid.all() \
                or any(abs(float(last.bpm[k]) - DUO_BPM[k]) > BPM_TOL
                       for k in range(2)):
            raise AssertionError(f"LivePipeline(k_faces=2): equal {same}, "
                                 f"last {last}")
        profiled_submits(live.LivePipeline(cfg, k_faces=2), host,
                         "[app] LivePipeline(k_faces=2)")
        out["s"]["LivePipeline k_faces=2"] = wall
        del host

        # The K=2 pool, 4 slots; slots 2 and 3 see the clip mirrored, so
        # their face0 is the 96 BPM subject.
        pool = serving.BpmServer(cfg, n_slots=DUO_SLOTS, k_faces=2)
        for _ in range(DUO_SLOTS):
            pool.attach()
        mirrored = duo.flip(2)
        st = live.init_state_multi(cfg, 2, dev)
        same = True
        t0 = time.perf_counter()
        for i in range(DUO_POOL_T):
            outs = pool.tick({s: (duo[i] if s < 2 else mirrored[i])
                              for s in range(DUO_SLOTS)})
            st, r = live.step_multi(st, duo[i], cfg, 2)
            r = live.unpack_output(live.pack_output(r).cpu().numpy())
            same &= all(np.array_equal(getattr(outs[0], k), getattr(r, k))
                        for k in r._fields)
        wall = time.perf_counter() - t0
        ends = {s: (outs[s].bpm.tolist(), outs[s].bpm_valid.tolist())
                for s in range(DUO_SLOTS)}
        want = {s: DUO_BPM if s < 2 else DUO_BPM[::-1]
                for s in range(DUO_SLOTS)}
        log(f"[app] pool k_faces=2, {DUO_SLOTS} slots x {DUO_POOL_T} ticks "
            f"of {PW}x{PH}: {wall:.2f} s with step_multi beside it; slot 0 "
            f"== step_multi {same}; last BPM and validity {ends}")
        if not same or any(not all(ends[s][1]) or any(
                abs(ends[s][0][k] - want[s][k]) > BPM_TOL for k in range(2))
                for s in range(DUO_SLOTS)):
            raise AssertionError(f"pool k_faces=2: equal {same}, {ends}")
        out["s"]["pool k_faces=2"] = wall
        del duo, mirrored, pool

        # evm_magnify on a 1080p clip with a 55 BPM pulse: one chunk, K6
        # and K7 once each.
        clip, _ = make_clip(dev, MAG_APP_T, H, W, seed=SEED + 6, bpm=EVM_BPM)
        src, dst = os.path.join(tmp, "evm.avi"), os.path.join(tmp, "mag.mp4")
        vio.write_video(clip.cpu().numpy(), src, FPS, fourcc="MJPG")
        reset_counters("k6.launches", "k7.launches")
        rc, lines, wall = call(evm_magnify.main, [src, dst])
        torch.cuda.synchronize()
        k6 = out["launches"]["K6"] = counter("k6.launches")
        k7 = out["launches"]["K7"] = counter("k7.launches")
        mag, _ = vio.read_video(dst)
        gain = cheek_pulse(torch.as_tensor(mag, device=dev), EVM_BPM) \
            / cheek_pulse(clip, EVM_BPM)
        log(f"[app] evm_magnify: exit {rc} in {wall:.2f} s "
            f"({MAG_APP_T / wall:.1f} frames/s with decode and encode); K6 "
            f"{k6}, K7 {k7} launches; output {mag.shape}; cheek "
            f"pulse gain {gain:.2f}x")
        if rc != 0 or k6 != 1 or k7 != 1 \
                or mag.shape != tuple(clip.shape) or not gain > 5.0:
            raise AssertionError(f"evm_magnify: exit {rc}, K6 "
                                 f"{k6}, K7 {k7}, {mag.shape}, "
                                 f"gain {gain}")
        out["s"]["evm_magnify"] = wall
        del clip, mag

        # validation.main in a directory of its own.
        vdir = os.path.join(tmp, "validation")
        os.makedirs(vdir)
        cwd = os.getcwd()
        os.chdir(vdir)
        try:
            rc, lines, wall = call(validation.main, [])
        finally:
            os.chdir(cwd)
        worst = next((ln for ln in lines if ln.startswith("Worst-case")), "")
        log(f"[app] validation.main: exit {rc} in {wall:.2f} s; wrote "
            f"{sorted(os.listdir(vdir))}; {worst}")
        if rc != 0 or os.listdir(vdir) != ["VALIDATION_TORCH.md"]:
            raise AssertionError(f"validation.main: exit {rc}, "
                                 f"{os.listdir(vdir)}")
        out["s"]["validation.main"] = wall

        # entry(): the fused form (K1) once, equal to measure_green_avg.
        fn, args = tentry.entry()
        reset_counters("k1.launches")
        t0 = time.perf_counter()
        bpm, valid = fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["launches"]["K1"] = counter("k1.launches")
        cfg = PipelineConfig(window_seconds=4.0, acquisition_seconds=2.0)
        _, mbpm, mvalid = offline.measure_green_avg(args[0], 30.0, cfg,
                                                    use_pallas="fused")
        same = np.array_equal(bpm.cpu().numpy(), mbpm) \
            and np.array_equal(valid.cpu().numpy(), mvalid)
        log(f"[app] entry(): {tuple(args[0].shape)} frames in {wall:.3f} s, "
            f"K1 launches {out['launches']['K1']}, {int(valid.sum())} valid; "
            f"== measure_green_avg(use_pallas='fused'): {same}")
        if out["launches"]["K1"] != 1 or not same or not bool(valid.any()):
            raise AssertionError(f"entry(): K1 {out['launches']['K1']}, "
                                 f"equal {same}")
        out["s"]["entry"] = wall
        # K1 against its plain version at the shape entry() gives it.
        carry = fused_cuda.init_carry(dev)
        got, got_c = fused_cuda.fused_detect_roi_carry(args[0], carry)
        want, want_c = fused_cuda.fused_detect_roi_plain(args[0], carry)
        out["k1_err"] = compare(f"K1 at entry()'s {tuple(args[0].shape)}",
                                tuple(got) + (got_c,), tuple(want) + (want_c,))
        log(f"[check] K1 == plain at entry()'s {tuple(args[0].shape)}: "
            f"max |err| {out['k1_err']}")
    finally:
        tmp_dir.cleanup()
    log(f"[app] check times ({card}): " + ", ".join(
        f"{k} {v:.2f} s" for k, v in out["s"].items()))
    return out


def spy(module, name: str, calls: list, keep: int = 1):
    """Replace ``module.name`` by a wrapper that keeps the arguments of its
    first ``keep`` calls in ``calls``; returns a function that puts the
    original back."""
    orig = getattr(module, name)

    def wrapper(*args, **kw):
        if len(calls) < keep:
            calls.append((args, kw))
        return orig(*args, **kw)

    setattr(module, name, wrapper)
    return lambda: setattr(module, name, orig)


def start_farm_workers(outdir: str):
    """The two-process farm (``vhr_tpu_torch.parallel.farm_worker``): two
    processes on this card, joined on gloo over localhost, 4 places each;
    returns ``(processes, start time)``."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vhr_tpu_torch.parallel.farm_worker",
         str(rank), "2", str(port), outdir], cwd=repo, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    return procs, time.perf_counter()


def finish_farm_workers(procs, t_start: float, outdir: str) -> dict:
    """Wait for both farm workers, each within FARM_WORKER_TIMEOUT of its
    start; either failing or timing out fails the phase (both are stopped
    either way).  Both must have gathered the same farm and pool outputs,
    host 0's frames must have reached host 1, and every pool slot must
    read its 78 BPM subject within 10 BPM."""
    logs = []
    try:
        for p in procs:
            left = max(1.0, FARM_WORKER_TIMEOUT
                       - (time.perf_counter() - t_start))
            logs.append(p.communicate(timeout=left)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t_start
    for rank, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"farm worker {rank} exit {p.returncode}:"
                                 f"\n{text[-3000:]}")
    r0, r1 = (json.load(open(os.path.join(outdir, f"ok_{r}.json")))
              for r in range(2))
    if r0 != r1 or r0["serve_src_sum"] == 0:
        raise AssertionError("the two farm workers disagree, or host 0's "
                             "frames did not arrive")
    bpms = r0["serve_bpm_last"]
    if max(abs(b - 78.0) for b in bpms) > 10.0:
        raise AssertionError(f"the SPMD pool's last BPMs {bpms}")
    # psum across the processes: every place's value 10 * rank + place.
    if r0["psum_stream"] != [52.0] * 4 \
            or r0["psum_data"] != [10.0 + 2 * m for m in range(4)]:
        raise AssertionError(f"psum across the workers: "
                             f"{r0['psum_stream']}, {r0['psum_data']}")
    log(f"[multi] two worker processes on {r0['places'][0]} (gloo, 4 places "
        f"each): exit 0 in {wall:.1f} s; gathered farm of "
        f"{len(r0['bpm'])} streams equal on both, last BPMs "
        f"{[b[-1] for b in r0['bpm']]}; host 0's frames on host 1 (sum "
        f"{r0['serve_src_sum']}); SPMD pool's last BPMs {bpms}; psum over "
        f"the 8 places {r0['psum_stream']}, over data {r0['psum_data']}")
    return dict(wall=wall)


def run_farm(dev, card: str) -> dict:
    """The stream farm at BASELINE's 64 concurrent 720p streams (T=32, 30
    fps, 1 s windows) over FARM_PLACES places of the card: the skin leg
    (``downsample=4``, K2 a shard) and the fused leg (row pool 8, gate
    0.15, K1 a shard), each equal to the same call on a 1-place mesh;
    then the MediaPipe farm (64 x 8 frames of the portrait at 720p, 10
    fps, K5 in each shard).  Each leg is timed on its second call, the
    first warming it up.  Each kernel of a leg is held against its plain
    version on one shard's own input."""
    import cv2
    import numpy as np
    import torch
    from vhr_tpu_torch.config import PipelineConfig
    from vhr_tpu_torch.models import mediapipe_face, tflite_exec
    from vhr_tpu_torch.models.skin_detector import SkinDetectorConfig
    from vhr_tpu_torch.ops import fused_cuda, roi_means_cuda
    from vhr_tpu_torch.parallel import mesh, streams
    from vhr_tpu_torch.utils.realface import real_face_image

    out = {"launches": {}, "s": {}}
    t_phase = time.perf_counter()
    farm = torch.empty((FARM_S, FARM_T, PH, PW, 3), dtype=torch.uint8,
                       device=dev)
    for i in range(FARM_S):
        farm[i] = make_clip(dev, FARM_T, PH, PW, seed=SEED + 100 + i,
                            bpm=55.0 + 55.0 * i / FARM_S)[0]
    torch.cuda.synchronize()
    cfg = PipelineConfig(window_seconds=1.0, acquisition_seconds=0.5)
    places = mesh.stream_mesh([dev] * FARM_PLACES)
    one = mesh.stream_mesh([dev])
    expect = FARM_S * (FARM_T - cfg.acquisition_len(FPS) + 1)
    legs = [("skin", dict(det=SkinDetectorConfig(downsample=4)), "K2",
             "k2.launches", "roi_channel_means_cuda"),
            ("fused", dict(use_fused=True, detect_row_pool=8,
                           gate_margin=0.15), "K1", "k1.launches",
             "fused_detect_roi_cuda")]
    for leg, kw, k, key, fn_name in legs:
        # One warm-up call, then the counted and timed one.
        streams.multistream_green_bpm(farm, FPS, places, cfg, **kw)
        torch.cuda.synchronize()
        calls = []
        put_back = spy(streams, fn_name, calls)
        reset_counters(key)
        try:
            t0 = time.perf_counter()
            res = streams.multistream_green_bpm(farm, FPS, places, cfg, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            put_back()
        launches = out["launches"][k] = counter(key)
        ref = streams.multistream_green_bpm(farm, FPS, one, cfg, **kw)
        valid, ok = res.valid, ref.valid
        n_valid = int(valid.sum())
        same_green = torch.equal(res.green, ref.green)
        bpm_err = float((res.bpm[ok] - ref.bpm[ok]).abs().max())
        log(f"[farm {leg}] {FARM_S} streams x {FARM_T} x {PW}x{PH} over "
            f"{FARM_PLACES} places: {k} launches {launches}; "
            f"{FARM_S * FARM_T / wall:.1f} frames/s ({wall:.2f} s, "
            f"{card}); valid {n_valid}/{expect}; == 1 place: validity "
            f"{torch.equal(valid, ok)}, green {same_green}, BPM max |err| "
            f"{bpm_err:.3g}")
        if launches != FARM_PLACES:
            raise AssertionError(f"farm {leg}: {k} launched {launches} "
                                 f"times")
        if n_valid < 0.95 * expect or not bool(torch.isfinite(
                res.bpm).all()):
            raise AssertionError(f"farm {leg}: {n_valid} valid of {expect}")
        if not torch.equal(valid, ok) or not same_green or bpm_err > 1e-4:
            raise AssertionError(f"farm {leg}: 4 places differ from 1")
        (args, kwargs), = calls
        if leg == "skin":
            out["k2_err"] = check_roi_means(
                roi_means_cuda.roi_channel_means_cuda, "K2",
                [("the skin farm's first shard", args[0], args[1], {})])
        else:
            carry = fused_cuda.init_carry(dev)
            got = fused_cuda.fused_detect_roi_carry(args[0], carry, **kwargs)
            want = fused_cuda.fused_detect_roi_plain(args[0], carry,
                                                     **kwargs)
            torch.cuda.synchronize()
            out["k1_err"] = compare(
                "K1 on the fused farm's first shard",
                tuple(got[0]) + (got[1],), tuple(want[0]) + (want[1],))
            log(f"[check] K1 == plain on the fused farm's first shard "
                f"{tuple(args[0].shape)}, seq_len={kwargs['seq_len']}")
        out["s"][leg] = wall
    del farm, res, ref

    # The MediaPipe farm: the portrait resized to 720p, a few u8 of offset
    # a frame drawn on the card, every frame through the detector.
    img = cv2.resize(real_face_image(), (PW, PH), interpolation=cv2.INTER_AREA)
    base = torch.as_tensor(img, device=dev).to(torch.int16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    offs = torch.randint(0, 4, (FARM_S, MP_FARM_T, 1, 1, 1), generator=gen,
                         device=dev, dtype=torch.int16)
    mp_frames = (base + offs).clamp(0, 255).to(torch.uint8)
    cfg_mp = PipelineConfig(window_seconds=0.8, acquisition_seconds=0.8)
    det = mediapipe_face.make_mediapipe_detector()
    streams.multistream_green_bpm(mp_frames, MP_FARM_FPS, places, cfg_mp,
                                  detector=det)      # the warm-up call
    torch.cuda.synchronize()
    calls = []
    put_back = spy(tflite_exec, "residual_stage", calls, keep=4)
    reset_counters("k5.launches")
    try:
        t0 = time.perf_counter()
        res = streams.multistream_green_bpm(mp_frames, MP_FARM_FPS, places,
                                            cfg_mp, detector=det)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        put_back()
    out["launches"]["K5"] = counter("k5.launches")
    acq = cfg_mp.acquisition_len(MP_FARM_FPS)
    valid = res.valid.cpu().numpy()
    bpm = res.bpm.cpu().numpy()
    band = cfg_mp.band
    in_band = bool(((bpm[valid] >= band.low_hz * 60 - 1e-6)
                    & (bpm[valid] <= band.high_hz * 60 + 1e-6)).all())
    log(f"[farm mediapipe] {FARM_S} streams x {MP_FARM_T} x {PW}x{PH} of the "
        f"portrait over {FARM_PLACES} places: K5 launches "
        f"{counter('k5.launches')}; {FARM_S * MP_FARM_T / wall:.1f} "
        f"frames/s ({wall:.2f} s, {card}); valid after the acquisition "
        f"{int(valid[:, acq - 1:].sum())}/{valid[:, acq - 1:].size}, BPM in "
        f"band {in_band} (median {float(np.median(bpm[valid])):.2f})")
    if counter("k5.launches") < FARM_PLACES or not valid[:, acq - 1:].all() \
            or not in_band:
        raise AssertionError("the MediaPipe farm: K5 not launched in every "
                             "shard, a validity hole or an out-of-band BPM")
    k5_err = 0.0
    for (x, wts, w_row), _ in calls:
        e, scale = check_k5(x, wts, w_row)
        k5_err = max(k5_err, e)
        log(f"[check] K5 on the MediaPipe farm's first shard, "
            f"{tuple(x.shape)} {x.dtype}: max |err| {e:.3g} of max|y| "
            f"{scale:.3g}")
    out["k5_err"] = k5_err
    out["s"]["mediapipe"] = wall
    out["s"]["farm"] = time.perf_counter() - t_phase
    return out


def run_long(dev, card: str) -> dict:
    """The time-sharded long-recording measure: a 720p clip of LONG_T
    frames (2 min at 30 fps) over FARM_PLACES places with
    ``PipelineConfig()`` (``T_local`` = the 30 s window): validity equal
    to ``offline.measure_green_avg`` on the same frames, BPM within
    ``rtol=1e-5, atol=1e-4`` where valid; with ``bandpass=True`` the
    median BPM within 3 of the truth.  K2 a shard, held against its plain
    version on the first shard's input."""
    import numpy as np
    import torch
    from vhr_tpu_torch.config import PipelineConfig
    from vhr_tpu_torch.ops import roi_means_cuda
    from vhr_tpu_torch.parallel import long as vlong
    from vhr_tpu_torch.parallel import mesh
    from vhr_tpu_torch.pipeline import offline

    t_phase = time.perf_counter()
    clip, _ = make_clip(dev, LONG_T, PH, PW, seed=SEED + 9)
    torch.cuda.synchronize()
    cfg = PipelineConfig()
    places = mesh.make_mesh(("time",), devices=[dev] * FARM_PLACES)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    calls = []
    put_back = spy(vlong, "roi_channel_means_cuda", calls)
    reset_counters("k2.launches")
    try:
        t0 = time.perf_counter()
        bpm, ok, _ = vlong.measure_green_avg_sharded(clip, FPS, places, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        put_back()
    launches = counter("k2.launches")
    peak = torch.cuda.max_memory_allocated() - base
    t0 = time.perf_counter()
    _, bpm_1d, ok_1d = offline.measure_green_avg(clip, FPS, cfg,
                                                 use_pallas="roi")
    wall_1d = time.perf_counter() - t0
    bpm, ok = bpm.cpu().numpy(), ok.cpu().numpy()
    reset_counters("k2.launches")
    t0 = time.perf_counter()
    bpm_bp, ok_bp, _ = vlong.measure_green_avg_sharded(clip, FPS, places,
                                                       cfg, bandpass=True)
    torch.cuda.synchronize()
    wall_bp = time.perf_counter() - t0
    launches += counter("k2.launches")
    bpm_bp, ok_bp = bpm_bp.cpu().numpy(), ok_bp.cpu().numpy()
    expect = LONG_T - cfg.acquisition_len(FPS) + 1
    med_bp = float(np.median(bpm_bp[ok_bp])) if ok_bp.any() else math.nan
    err = (float(np.abs(bpm[ok_1d] - bpm_1d[ok_1d]).max())
           if ok_1d.any() else 0.0)
    log(f"[long] {LONG_T} x {PW}x{PH} ({clip.numel() / 1e9:.2f} GB) over "
        f"{FARM_PLACES} places, T_local {LONG_T // FARM_PLACES}: sharded "
        f"{wall:.2f} s, unsharded {wall_1d:.2f} s, with the band-pass "
        f"{wall_bp:.2f} s ({card}); K2 launches {launches}; peak device "
        f"memory above the clip {peak / 1e9:.3f} GB; valid {int(ok.sum())}/"
        f"{expect}, == unsharded {np.array_equal(ok, ok_1d)}, BPM max |err| "
        f"{err:.3g}; band-pass valid {int(ok_bp.sum())}, median BPM "
        f"{med_bp:.3f} vs truth {TRUTH_BPM:g}")
    if launches != 2 * FARM_PLACES:
        raise AssertionError(f"the long measure: K2 launched {launches} "
                             f"times")
    if not np.array_equal(ok, ok_1d) or ok.sum() < 0.95 * expect:
        raise AssertionError("the long measure's validity differs from the "
                             "unsharded measure's")
    np.testing.assert_allclose(bpm[ok_1d], bpm_1d[ok_1d], rtol=1e-5,
                               atol=1e-4)
    if ok_bp.sum() < 0.95 * expect or abs(med_bp - TRUTH_BPM) > 3.0:
        raise AssertionError(f"the band-passed long measure: "
                             f"{int(ok_bp.sum())} valid, median {med_bp}")
    (args, _), = calls
    k2_err = check_roi_means(roi_means_cuda.roi_channel_means_cuda, "K2",
                             [("the long measure's first shard", args[0],
                               args[1], {})])
    return dict(launches={"K2": launches}, k2_err=k2_err, peak=peak,
                s=dict(sharded=wall, unsharded=wall_1d, bandpass=wall_bp,
                       phase=time.perf_counter() - t_phase))


def run_pool_mesh(dev, use_fused: bool, recorded: list, card: str) -> dict:
    """The 64-slot 720p pool with its slots over FARM_PLACES places of the
    card for the first ``len(recorded)`` ticks of the serving phase's
    schedule and population: every tick's outputs equal to the unsharded
    pool's (``recorded``, phase 10), one K4 (fused) or K2 (skin) launch a
    place a tick, and that kernel held against its plain version on the
    last tick's first place."""
    import numpy as np
    import torch
    from vhr_tpu_torch import serving
    from vhr_tpu_torch.ops import fused_cuda, roi_means_cuda
    from vhr_tpu_torch.parallel import mesh
    from vhr_tpu_torch.pipeline import live

    cfg = live.LiveConfig(fps=FPS, use_fused=use_fused)
    pool = serving.BpmServer(cfg, n_slots=SLOTS, slot_axis="stream",
                             mesh=mesh.stream_mesh([dev] * FARM_PLACES))
    subj = Subjects(dev, SLOTS, PH, PW, SEED + 4)
    if use_fused:
        k, key, fn_name = "K4", "k4.launches", "fused_detect_roi_slots"
    else:
        k, key, fn_name = "K2", "k2.launches", "roi_channel_means_cuda"
    calls = []
    reset_counters(key)
    t0 = time.perf_counter()
    for t, send, _, outs, _ in pool_ticks(pool, subj, len(recorded)):
        if t == len(recorded) - 2:        # keep the last tick's first call
            put_back = spy(live, fn_name, calls)
        for s in send:
            for f in outs[s]._fields:
                if not np.array_equal(np.asarray(getattr(outs[s], f)),
                                      np.asarray(getattr(recorded[t][s], f))):
                    raise AssertionError(
                        f"sharded pool tick {t} slot {s}: {f} "
                        f"{getattr(outs[s], f)} != unsharded "
                        f"{getattr(recorded[t][s], f)}")
    put_back()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter(key)
    form = "fused" if use_fused else "skin"
    log(f"[pool mesh {form}] {SLOTS} slots of {PW}x{PH} over {FARM_PLACES} "
        f"places, {len(recorded)} ticks in {wall:.1f} s ({card}, beside "
        f"the two farm workers): every "
        f"output == the unsharded pool's; {k} launches {launches}")
    if launches != FARM_PLACES * len(recorded):
        raise AssertionError(f"sharded {form} pool: {k} launched {launches} "
                             f"times in {len(recorded)} ticks")
    args, kwargs = calls[0]
    if use_fused:
        got = fused_cuda.fused_detect_roi_slots(*args, **kwargs)
        want = fused_cuda.fused_detect_roi_slots_plain(*args, **kwargs)
        torch.cuda.synchronize()
        same_bits("K4 on the sharded pool's first place",
                  tuple(got[0]) + (got[1],), tuple(want[0]) + (want[1],))
        log(f"[check] K4 == plain bit for bit on the sharded pool's first "
            f"place, {tuple(args[0].shape)}")
        err = 0.0
    else:
        err = check_roi_means(roi_means_cuda.roi_channel_means_cuda, "K2",
                              [("the sharded skin pool's first place",
                                args[0], args[1], {})])
    return dict(launches={k: launches}, err=err, s=wall)


def run_multidevice(dev, card: str, pools: dict) -> dict:
    """Phase 14b: the stream and MediaPipe farms and the time-sharded long
    measure, timed with nothing else on the card or the host; then the
    two-process farm in the background while the sharded fused and skin
    pools (``pools``: phase 10's recorded outputs) run, whose seconds thus
    share the card and the host with the workers; the workers are waited
    for last."""
    out = {"launches": {"K1": 0, "K2": 0, "K4": 0, "K5": 0}, "s": {}}
    t_phase = time.perf_counter()
    farm = run_farm(dev, card)
    long_run = run_long(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        procs, t_start = start_farm_workers(tmp)
        try:
            pool_runs = {form: run_pool_mesh(dev, form == "fused",
                                             pools[form], card)
                         for form in ("fused", "skin")}
        except BaseException:
            for p in procs:
                p.kill()
                p.wait()
            raise
        out["s"]["workers"] = finish_farm_workers(procs, t_start,
                                                  tmp)["wall"]
    for part in [farm, long_run] + list(pool_runs.values()):
        for k, n in part["launches"].items():
            out["launches"][k] += n
    out["k1_err"], out["k5_err"] = farm["k1_err"], farm["k5_err"]
    out["k2_err"] = max(farm["k2_err"], long_run["k2_err"],
                        pool_runs["skin"]["err"])
    out["k4_err"] = pool_runs["fused"]["err"]
    out["s"].update(farm=farm["s"]["farm"], long=long_run["s"]["phase"],
                    pool_fused=pool_runs["fused"]["s"],
                    pool_skin=pool_runs["skin"]["s"],
                    phase=time.perf_counter() - t_phase)
    log(f"[multi] phase 14b in {out['s']['phase']:.1f} s ({card}): "
        + ", ".join(f"{k} {v:.1f} s" for k, v in out["s"].items())
        + f"; kernel launches on its paths {out['launches']}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    from vhr_tpu_torch import _build
    from vhr_tpu_torch.config import PipelineConfig
    from vhr_tpu_torch.ops import fused_cuda, roi, roi_means_cuda
    from vhr_tpu_torch.ops import windows as vwin
    from vhr_tpu_torch.ops.reduce import roi_channel_means
    from vhr_tpu_torch.pipeline import offline
    from vhr_tpu_torch.validation import cpu_reference_green_avg

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)}")

    # 1. Build.
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")

    # 2. The clip, on the card; phase 8c's real portrait starts on the host.
    t0 = time.perf_counter()
    frames, truth_boxes = make_clip(dev, T, H, W)
    torch.cuda.synchronize()
    log(f"[clip] {tuple(frames.shape)} u8 made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    real = start_real_face_clip()
    batches = start_train_batches()

    # 3. Kernels against their plain versions, on the card.
    cfg = PipelineConfig()
    clip_rois = roi.cheek_roi(truth_boxes, cfg.roi, W, H)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x1 = torch.randint(-20, W, (T,), generator=gen, device=dev)
    y1 = torch.randint(-20, H, (T,), generator=gen, device=dev)
    rand_rois = torch.stack([x1, y1,
                             x1 + torch.randint(-5, 800, (T,), generator=gen,
                                                device=dev),
                             y1 + torch.randint(-5, 400, (T,), generator=gen,
                                                device=dev)], -1)
    rand_rois[:8] = torch.tensor([0, 0, 0, 0], device=dev)
    rand_rois[8:16] = torch.tensor([100, 200, 50, 300], device=dev)
    rand_rois[16:24] = torch.tensor([-50, -40, W + 50, H + 40], device=dev)
    # K2 and K3 share csrc/roi_means.cu: each entry and each of its two
    # instances (the vectorised one, which the plan takes for every aligned
    # layout, and the generic one) must equal the plain version bit for bit.
    k2_err = check_roi_means(roi_means_cuda.roi_channel_means_cuda, "K2", [
        ("clip", frames, clip_rois, {}), ("random", frames, rand_rois, {})])
    # K3 also on a stream's chunk and on rows padded to a wider pitch (a
    # reader's staging buffer).
    padded = torch.randint(0, 256, (T, H, W * 3 + 64), generator=gen,
                           device=dev, dtype=torch.uint8)
    padded[..., :W * 3] = frames.reshape(T, H, W * 3)
    k3_err = check_roi_means(
        roi_means_cuda.roi_channel_means_batched_cuda, "K3", [
            ("clip", frames, clip_rois, {}),
            ("random", frames, rand_rois, {}),
            (f"chunk of {STREAM_CHUNK}", frames[:STREAM_CHUNK],
             clip_rois[:STREAM_CHUNK], {}),
            ("padded clip", padded, clip_rois, dict(width=W)),
            ("padded random", padded, rand_rois, dict(width=W))])
    del padded

    # K1 over its knobs, equal to the plain version bit for bit; the last
    # two cases from a base off the 16-byte grid (K1's scalar skin pass and
    # the generic K2), on the clip's first 64 frames.
    k1_err = 0.0
    configs = [dict(detect_row_pool=p, detect_every=d, gate_margin=g)
               for p in (1, 8) for d in (1, 4) for g in (None, 0.5)]
    configs += [dict(detect_row_pool=8, gate_margin=0.5, seq_len=480),
                dict(detect_row_pool=2, gate_margin=0.15),
                dict(detect_row_pool=4, gate_margin=0.15),
                dict(detect_row_pool=1, gate_margin=0.15, off_grid=64),
                dict(detect_row_pool=8, gate_margin=0.15, off_grid=64)]
    for kw in configs:
        kw = dict(kw)
        x, buf, n_off = frames, None, kw.pop("off_grid", 0)
        if n_off:
            buf = torch.empty(n_off * H * W * 3 + 1, dtype=torch.uint8,
                              device=dev)
            x = buf[1:].view(n_off, H, W * 3)
            x.copy_(frames[:n_off].reshape(n_off, H, W * 3))
            assert fused_cuda.skin_instance(W * 3, x.data_ptr()) == "scalar"
        carry = fused_cuda.init_carry(dev)
        got, got_c = fused_cuda.fused_detect_roi_carry(x, carry, **kw)
        want, want_c = fused_cuda.fused_detect_roi_plain(x, carry, **kw)
        torch.cuda.synchronize()
        err = compare(f"K1 {kw}", tuple(got) + (got_c,),
                      tuple(want) + (want_c,))
        if err != 0.0:
            raise AssertionError(f"K1 {kw}: means differ by {err}")
        k1_err = max(k1_err, err)
        n = x.shape[0]
        log(f"[check] K1 == plain bit for bit {kw}"
            f"{f', {n} frames off the 16-byte grid' if n_off else ''}: "
            f"det_valid {int(got.det_valid.sum())}/{n}, roi_valid "
            f"{int(got.roi_valid.sum())}/{n}")
        x = buf = None
    k4_err = check_k4(dev)
    ramp = check_ramp(dev, cfg)

    # 4. The offline measure at the flagship configuration, counters from 0.
    acq, win = cfg.acquisition_len(FPS), cfg.window_len(FPS)
    reset_counters("k2.launches", "k2.vec")
    reset_counters("k1.launches", "ramp.launches")

    def fused_form():
        trace = offline.extract_signals_fused(frames, cfg,
                                              detect_row_pool=8)
        green = offline._fill_invalid(trace.bgr[:, cfg.channel], trace.valid)
        rolling = vwin.rolling_bpm_fft(green, FPS, cfg.band, win, acq)
        return (green, rolling.bpm.cpu().numpy(),
                (rolling.valid & trace.valid).cpu().numpy())

    def xla_form():
        _, bpm, valid = offline.measure_green_avg(frames, FPS, cfg,
                                                  use_pallas="roi")
        return bpm, valid

    results = {"fused": fused_form(), "roi": xla_form()}
    # The green trace that measure_green_avg estimated from, for the
    # numpy reference below.
    trace = offline.extract_signals(frames, cfg, use_pallas="roi")
    results["roi"] = (offline._fill_invalid(trace.bgr[:, cfg.channel],
                                            trace.valid),) + results["roi"]
    torch.cuda.synchronize()
    launches = {"K1": counter("k1.launches"), "K2": counter("k2.launches"),
                "R": counter("ramp.launches")}
    log(f"[main] kernel launches in the offline run: {launches}, K2 on the "
        f"vectorised instance {counter('k2.vec')}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the offline path never launched: "
                             f"{launches}")
    if counter("k2.vec") != launches["K2"]:
        raise AssertionError("K2 left the vectorised instance in the "
                             "offline run")
    for form, (green, bpm, valid) in results.items():
        n_valid, expect = int(valid.sum()), T - acq + 1
        if n_valid < 0.95 * expect:
            raise AssertionError(f"{form}: {n_valid} valid of {expect}")
        if not all(map(math.isfinite, bpm.tolist())):
            raise AssertionError(f"{form}: non-finite BPM")
        ref = cpu_reference_green_avg(green.cpu().numpy(), FPS,
                                      cfg.window_seconds,
                                      cfg.acquisition_seconds, cfg.band)
        idx = [i for i in ref if valid[i]]
        mae_ref = sum(abs(float(bpm[i]) - ref[i]) for i in idx) / len(idx)
        mae_truth = float(abs(bpm[valid] - TRUTH_BPM).mean())
        log(f"[main] {form}: valid {n_valid}/{expect} frames from the end "
            f"of the acquisition; BPM MAE vs numpy reference {mae_ref:.4f} "
            f"over "
            f"{len(idx)} frames; vs {TRUTH_BPM:g} BPM truth {mae_truth:.4f}")
        if len(idx) < 0.95 * n_valid or mae_ref > 0.5:
            raise AssertionError(f"{form}: MAE vs reference {mae_ref} "
                                 f"over {len(idx)} frames")

    log(f"[time] card: {card}")
    ms = {"fused": cuda_ms(fused_form), "roi": cuda_ms(xla_form)}
    for form, t_ms in ms.items():
        log(f"[time] {form} form end to end: {t_ms:.3f} ms / {T} frames = "
            f"{T / (t_ms / 1e3):.1f} frames/s, {t_ms * 1e3 / T:.3f} us/frame")

    # 5. The other offline measures, both forms, counters from 0 before
    # each call.
    t0 = time.perf_counter()
    measures = run_measures(dev, frames, cfg)
    log(f"[measures] phase in {time.perf_counter() - t0:.1f} s; kernel "
        f"launches in the measures' checked calls {measures}")
    for k, n in measures.items():
        launches[k] += n

    # 6. Streaming ingest from a file, counters from 0 before each form:
    # one decoder, DECODERS decoders, I420 staging.
    t0 = time.perf_counter()
    stream = run_streaming(dev, frames, cfg)
    log(f"[stream] phase in {time.perf_counter() - t0:.1f} s")
    launches["K3"] = stream["detect"]["launches"]
    launches["K1"] += (stream["decoders"]["launches"]
                       + stream["i420"]["fused"]["launches"])

    # 7. The EVM path: kernels against plain, magnify, the EVM measure.
    evm_checks = check_evm_kernels(dev, frames)
    t0 = time.perf_counter()
    evm_run = run_evm(dev, frames)
    log(f"[evm] phase in {time.perf_counter() - t0:.1f} s")
    launches["K6"] = evm_run["launches"]["K6"] \
        + evm_run["launches"]["K6 measure"]
    launches["K7"] = evm_run["launches"]["K7"]

    # 8. The MediaPipe detector (K5, K2), counters from 0 before its measure.
    t0 = time.perf_counter()
    mp_run = run_mediapipe(dev, cfg)
    log(f"[mediapipe] phase in {time.perf_counter() - t0:.1f} s")
    launches["K5"] = mp_run["launches"]["K5"]

    # 8b. The multi-face MediaPipe detector (K5 at B=128), the pose-robust
    # and polygon measures on the MediaPipe clip, and the apps with the
    # K=2 detector; counters from 0 before each path.
    t0 = time.perf_counter()
    lm_run = run_landmark_slice(dev, mp_run.pop("frames"), cfg, card)
    log(f"[landmark] phase in {time.perf_counter() - t0:.1f} s ({card}); "
        f"K5 launches {lm_run['launches']}")
    launches["K5"] += sum(lm_run["launches"].values())
    mp_run["k5_err"] = max(mp_run["k5_err"], lm_run["k5_err"])

    # 8c. The learned landmarker and the cascades (no repo kernel of their
    # own; K2 takes each single-face path's ROI means): the flagship clip,
    # the real portrait, two faces, the live pipeline; counters from 0
    # before each single-face path.
    t0 = time.perf_counter()
    learned = run_learned_slice(dev, frames, truth_boxes, cfg, card, real)
    log(f"[learned] phase in {time.perf_counter() - t0:.1f} s ({card}); "
        f"K2 launches {learned['launches']}")
    launches["K2"] += sum(learned["launches"].values())
    k2_err = max(k2_err, learned["k2_err"])

    # 16. Training: the trainer from scratch and the fine-tune recipe
    # through train.main, the fine-tuned weights through the K2 measure on
    # the flagship clip (K2's counter from 0), the dp×tp step, the dry run.
    t0 = time.perf_counter()
    trained = run_training(dev, frames, truth_boxes, cfg, card, batches)
    log(f"[train] phase in {time.perf_counter() - t0:.1f} s ({card}); "
        f"K2 launches {trained['launches']}")
    launches["K2"] += sum(trained["launches"].values())
    k2_err = max(k2_err, trained["k2_err"])

    # 9. The live pipeline (K4), counters from 0 before each mode.
    t0 = time.perf_counter()
    live_run = run_live(dev)
    log(f"[live] phase in {time.perf_counter() - t0:.1f} s")
    live_k4 = sum(v["launches"] for k, v in live_run.items()
                  if isinstance(v, dict) and "launches" in v)
    k4_err = max(k4_err, live_run["k4_err"])

    # 10. The serving pool, fused then skin-detector ticks, then the fused
    # tick under the adaptive method, then the I420 pool beside a BGR one,
    # counters from 0.
    reset_counters("k4.launches")
    t0 = time.perf_counter()
    fused_pool = run_pool(dev, use_fused=True, record=POOL_MESH_TICKS)
    torch.cuda.synchronize()
    launches["K4"] = counter("k4.launches")
    log(f"[pool fused] {time.perf_counter() - t0:.1f} s; kernel launches "
        f"K4={launches['K4']}")
    if launches["K4"] < 1:
        raise AssertionError("K4 never launched in the fused pool")
    reset_counters("k2.launches", "k2.vec")
    reset_counters("k4.launches")
    t0 = time.perf_counter()
    skin_pool = run_pool(dev, use_fused=False, record=POOL_MESH_TICKS)
    torch.cuda.synchronize()
    skin_k2 = counter("k2.launches")
    log(f"[pool skin] {time.perf_counter() - t0:.1f} s; kernel launches "
        f"K2={skin_k2} (vectorised {counter('k2.vec')}) "
        f"K4={counter('k4.launches')}")
    if skin_k2 < 1 or counter("k2.vec") != skin_k2:
        raise AssertionError("K2 never launched, or left the vectorised "
                             "instance, in the skin-detector pool")
    reset_counters("k4.launches")
    t0 = time.perf_counter()
    run_pool(dev, use_fused=True, method="adaptive")
    torch.cuda.synchronize()
    adaptive_k4 = counter("k4.launches")
    log(f"[pool fused adaptive] {time.perf_counter() - t0:.1f} s; kernel "
        f"launches K4={adaptive_k4}")
    if adaptive_k4 < 1:
        raise AssertionError("K4 never launched in the adaptive pool")
    launches["K4"] += adaptive_k4
    t0 = time.perf_counter()
    pool_i420 = run_pool_i420(dev)
    log(f"[pool i420] {time.perf_counter() - t0:.1f} s")
    launches["K4"] += pool_i420["launches"] + live_k4
    # K2's launches in the record: the offline run's, the MediaPipe
    # measure's and the skin pool's.
    launches["K2"] += mp_run["launches"]["K2"] + skin_k2

    # 11. The front-end, counters from 0: BGR clients, then an I420 one.
    reset_counters("k4.launches")
    served = run_server(dev)
    log(f"[server] kernel launches K4={counter('k4.launches')}")
    if counter("k4.launches") < 1:
        raise AssertionError("K4 never launched behind the server")
    reset_counters("k4.launches")
    t0 = time.perf_counter()
    run_server_i420(dev)
    log(f"[server i420] {time.perf_counter() - t0:.1f} s; kernel launches "
        f"K4={counter('k4.launches')}")
    if counter("k4.launches") < 1:
        raise AssertionError("K4 never launched behind the I420 server")

    # 12. The apps: the live app and the serving app's client mode.
    t0 = time.perf_counter()
    run_apps(dev, live_run["bgr_frames"], live_run["truth"])
    log(f"[apps] phase in {time.perf_counter() - t0:.1f} s")

    # 13. The analysis harness: a degradation sweep with green_avg and evm
    # (K6), then green_avg under the MediaPipe detector (K5); counters from
    # 0 before each sweep.
    t0 = time.perf_counter()
    analysis = run_analysis(dev, frames, card)
    log(f"[analysis] phase in {time.perf_counter() - t0:.1f} s ({card})")
    launches["K6"] += analysis["launches"]["K6"]
    launches["K5"] += analysis["launches"]["K5"]

    # 14. The apps and the multi-face path: the video app (skin, MediaPipe
    # with K5, --faces 2), LivePipeline and the pool with k_faces=2,
    # evm_magnify (K6, K7), bpp, validation.main, entry() (K1); counters
    # from 0 before each path.
    t0 = time.perf_counter()
    apps = run_app_slice(dev, frames, card)
    log(f"[app] phase in {time.perf_counter() - t0:.1f} s ({card})")
    for k, n in apps["launches"].items():
        launches[k] += n
    k1_err = max(k1_err, apps["k1_err"])

    # 14b. Multi-device: the stream farm (skin with K2, fused with K1), the
    # MediaPipe farm (K5), the time-sharded long measure (K2), the fused
    # (K4) and skin (K2) pools with their slots over places, and two farm
    # worker processes; counters from 0 before each path.
    multi = run_multidevice(dev, card, {
        "fused": fused_pool.pop("recorded"),
        "skin": skin_pool.pop("recorded")})
    for k, n in multi["launches"].items():
        launches[k] += n
    k1_err = max(k1_err, multi["k1_err"])
    k2_err = max(k2_err, multi["k2_err"])
    k4_err = max(k4_err, multi["k4_err"])
    mp_run["k5_err"] = max(mp_run["k5_err"], multi["k5_err"])

    # 15. Timing (CUDA events; frames resident on the card unless stated).
    # The fused offline form is bound by host launches: timed again here,
    # after the serving phases, it shows what the process's state costs.
    t_ms = cuda_ms(fused_form)
    log(f"[time] fused form end to end, after the serving phases: "
        f"{t_ms:.3f} ms / {T} frames = {T / (t_ms / 1e3):.1f} frames/s")
    for form, run in (("fused", fused_pool), ("skin", skin_pool)):
        pool, last = run["pool"], run["frames"]
        on_card = {s: last[s] for s in range(SLOTS)}
        host = {s: f for s, f in enumerate(last.cpu().numpy())}
        dev_ms = cuda_ms(lambda: pool.tick_async(on_card), inner=10)
        e2e_ms = wall_ms(lambda: pool.tick(host), inner=10)
        log(f"[time] pool {form} tick, {SLOTS} x {PW}x{PH}: device "
            f"{dev_ms:.3f} ms ({SLOTS / (dev_ms / 1e3):.1f} slot-frames/s, "
            f"frames on the card); wall with upload and fetch {e2e_ms:.3f} "
            f"ms ({SLOTS / (e2e_ms / 1e3):.1f} slot-frames/s)")
        run["ms"] = (dev_ms, e2e_ms)
    flag = dict(detect_row_pool=8)
    carry0 = fused_cuda.init_carry(dev)

    def k1_call():
        return fused_cuda.fused_detect_roi_carry(frames, carry0, **flag)

    # K1 by events with the card's queue filled ahead (the card alone) and
    # paced by the host, and each of its two launches under the profiler.
    # The tracer drops the kernels launched while it starts up (a short
    # trace late in a long process comes back empty), so 40 sums over the
    # clip, a kernel of another name, go first.
    k1_ms = cuda_ms(k1_call, reps=5, inner=10, queue_ahead=True)
    k1_paced = cuda_ms(k1_call, inner=10)

    def k1_traced():
        torch.cuda.synchronize()
        for _ in range(40):
            frames[:64].sum(dtype=torch.int32)
        torch.cuda.synchronize()
        for _ in range(20):
            k1_call()
        torch.cuda.synchronize()
        time.sleep(0.05)

    _, k1_split = device_profile(k1_traced, top=12)
    k1_split = [(name, ms_, n) for name, ms_, n in k1_split
                if "pass_kernel" in name or "roi_means" in name]
    log(f"[time] K1 at {W}x{H} x {T} (detect_row_pool=8): {k1_ms:.4f} ms "
        f"the queue filled ahead, {k1_paced:.4f} ms paced by the host; "
        f"its launches under the profiler: " + ("; ".join(
            f"{name[:50]} {ms_ / n:.4f} ms a launch ({n} of 20 traced)"
            for name, ms_, n in k1_split) or "no device work traced"))
    k1_plain = cuda_ms(lambda: fused_cuda.fused_detect_roi_plain(
        frames, carry0, **flag))
    k2_ms = cuda_ms(lambda: roi_means_cuda.roi_channel_means_cuda(
        frames, clip_rois), inner=10)
    k2_plain = cuda_ms(lambda: roi_channel_means(frames, clip_rois))
    k3_ms = cuda_ms(lambda: roi_means_cuda.roi_channel_means_batched_cuda(
        frames, clip_rois), inner=10)
    log(f"[time] K3 on the clip's cheek ROIs at {W}x{H} x {T}: kernel "
        f"{k3_ms:.3f} ms, K2 {k2_ms:.3f} ms, plain {k2_plain:.3f} ms (one "
        f"plain version for both)")
    # The same two with the card's queue filled ahead: the card alone.
    k2_paced, k3_paced = k2_ms, k3_ms
    k2_ms = cuda_ms(lambda: roi_means_cuda.roi_channel_means_cuda(
        frames, clip_rois), reps=5, inner=10, queue_ahead=True)
    k3_ms = cuda_ms(lambda: roi_means_cuda.roi_channel_means_batched_cuda(
        frames, clip_rois), reps=5, inner=10, queue_ahead=True)
    # K3 as streaming ingest launches it, on one chunk of STREAM_CHUNK.
    k3_chunk = cuda_ms(lambda: roi_means_cuda.roi_channel_means_batched_cuda(
        frames[:STREAM_CHUNK], clip_rois[:STREAM_CHUNK]), reps=5, inner=10,
        queue_ahead=True)
    chunk_bytes = roi_bytes(clip_rois[:STREAM_CHUNK], H, W)
    k3_chunk_bound = bound(chunk_bytes + STREAM_CHUNK * (16 + 16),
                           chunk_bytes)[0]
    log(f"[time] K2 {k2_ms:.4f} ms, K3 {k3_ms:.4f} ms with the queue filled "
        f"ahead; {k2_paced:.4f}, {k3_paced:.4f} ms paced by the host; K3 on "
        f"a chunk of {STREAM_CHUNK} frames {k3_chunk:.4f} ms, the queue "
        f"filled ahead, bound {k3_chunk_bound:.4f} ms (bytes)")
    # K1 as the fused streams launch it (BGR, 4 decoders, I420), on one
    # chunk of STREAM_CHUNK: every pixel read, 3 pooling adds a pixel and
    # ~20 operations a pooled cell's chroma test.
    k1_chunk = cuda_ms(lambda: fused_cuda.fused_detect_roi_carry(
        frames[:STREAM_CHUNK], carry0, **flag), reps=5, inner=10,
        queue_ahead=True)
    n = STREAM_CHUNK
    k1_chunk_bound = bound(n * H * W * 3 + n * (12 + 4 + 16 + 2) + 48,
                           3 * n * H * W + 20 * n * (H // 8) * W)
    log(f"[time] K1 on a chunk of {n} frames (detect_row_pool=8): "
        f"{k1_chunk:.4f} ms, the queue filled ahead, bound "
        f"{k1_chunk_bound[0]:.4f} ms ({k1_chunk_bound[1]})")
    # K2 as the skin-detector pool tick launches it: the pool's 64 slots of
    # 720p and the cheek ROIs the tick takes from them.
    from vhr_tpu_torch.pipeline.live import LiveConfig
    pool_frames = skin_pool["frames"]
    slot_rois = pool_rois(pool_frames, LiveConfig(fps=FPS))
    k2_err = max(k2_err, check_roi_means(
        roi_means_cuda.roi_channel_means_cuda, "K2",
        [(f"the skin pool's {SLOTS} x {PW}x{PH} slots", pool_frames,
          slot_rois, {})]))
    k2_pool = cuda_ms(lambda: roi_means_cuda.roi_channel_means_cuda(
        pool_frames, slot_rois), reps=5, inner=10, queue_ahead=True)
    pool_bytes = roi_bytes(slot_rois, PH, PW)
    k2_pool_bound = bound(pool_bytes + SLOTS * (16 + 16), pool_bytes)[0]
    log(f"[time] K2 on the skin pool's {SLOTS} x {PW}x{PH} slots "
        f"({pool_bytes / 1e6:.3f} MB of cheek ROIs): {k2_pool:.4f} ms, the "
        f"queue filled ahead, bound {k2_pool_bound:.4f} ms (bytes)")
    slot_frames = fused_pool["frames"]
    state = fused_pool["pool"]._state
    carry = torch.cat([state.last_box, state.hold_budget[:, None],
                       state.has_last.to(torch.int32)[:, None]], 1)
    # Two more K4 launches on the pool's last frames and state must give
    # the same bits: the last block of each slot left the accumulators
    # clean.
    first = fused_cuda.fused_detect_roi_slots(slot_frames, carry,
                                              state.frame_idx)
    again = fused_cuda.fused_detect_roi_slots(slot_frames, carry,
                                              state.frame_idx)
    torch.cuda.synchronize()
    same_bits("K4 called twice", tuple(again[0]) + (again[1],),
              tuple(first[0]) + (first[1],))
    log("[check] K4 twice on the pool's last frames and state: same bits")
    k4_cases = [("default", {}),
                ("detect_row_pool=8", dict(detect_row_pool=8)),
                ("gate_margin=0.5", dict(gate_margin=0.5))]

    def k4_call(kw):
        return fused_cuda.fused_detect_roi_slots(
            slot_frames, carry, state.frame_idx, **kw)

    # The host takes about as long to enqueue a K4 call as the card to run
    # it, so K4 is timed with the queue filled ahead, and for comparison
    # paced by the host as the other kernels are.
    k4_times = {name: cuda_ms(lambda kw=kw: k4_call(kw), inner=10,
                              queue_ahead=True) for name, kw in k4_cases}
    k4_paced = {name: cuda_ms(lambda kw=kw: k4_call(kw), inner=10)
                for name, kw in k4_cases}
    log("[time] K4 a call by events, the queue filled ahead: " + ", ".join(
        f"{name} {t_ms:.4f} ms" for name, t_ms in k4_times.items())
        + "; paced by the host: " + ", ".join(
            f"{name} {t_ms:.4f} ms" for name, t_ms in k4_paced.items()))

    # The kernels torch.profiler sees in 20 calls of each case, in one
    # trace.  The tracer drops the kernels launched while it starts up (a
    # short trace can come back empty), so 40 calls with detect_row_pool=2,
    # whose kernel has a name of its own, go first.  A call that took more
    # than one launch would show as a second kernel name or as more
    # kernels than calls: that fails; fewer kernels than calls are the
    # tracer's and are logged.
    def k4_traced():
        torch.cuda.synchronize()
        for _ in range(40):
            k4_call(dict(detect_row_pool=2))
        torch.cuda.synchronize()
        for _, kw in k4_cases:
            for _ in range(20):
                k4_call(kw)
        torch.cuda.synchronize()
        time.sleep(0.05)

    busy, top = device_profile(k4_traced)
    calls = {"slot_tick_kernel<1>": 40, "slot_tick_kernel<8>": 20,
             "slot_tick_kernel<2>": 40}
    seen = {}
    for k, ms_, n in top:
        tag = next((t for t in calls if t in k), None)
        if tag is None or n > calls[tag]:
            raise AssertionError(f"K4: one kernel a call expected, the "
                                 f"profiler saw {top}")
        seen[tag] = (ms_ / n, n)
    log("[time] K4 under the profiler, one kernel a call: " + "; ".join(
        f"{tag} {ms_:.4f} ms a launch ({n} of {calls[tag]} launches "
        f"traced)" for tag, (ms_, n) in sorted(seen.items()))
        + " (<1>: default and gated, <8>: detect_row_pool=8, <2>: the "
        "warm-up)" if seen else
        "[time] K4 under the profiler: no device work traced")
    k4_ms = k4_times["default"]
    k4_plain = cuda_ms(lambda: fused_cuda.fused_detect_roi_slots_plain(
        slot_frames, carry, state.frame_idx))
    for k, a, b, n in [("K1", k1_ms, k1_plain, T), ("K2", k2_ms, k2_plain, T),
                       ("K3", k3_ms, k2_plain, T),
                       ("K4", k4_ms, k4_plain, SLOTS)]:
        log(f"[time] {k}: kernel {a:.3f} ms ({a * 1e3 / n:.3f} us/frame), "
            f"plain {b:.3f} ms ({b * 1e3 / n:.3f} us/frame)")

    # The ramp kernel at the skin cell's shapes (a call's 8 recordings): the
    # queue filled ahead, and its plain version.  Its launches in the record
    # are the offline run's (phase 4), counted from 0 there.
    rx, r_first, r_last = ramp["x"], ramp["n_first"], ramp["n_last"]
    r_out = (torch.empty((r_last - r_first + 1, RAMP_S), device=dev),
             torch.empty((r_last - r_first + 1, RAMP_S), dtype=torch.bool,
                         device=dev))
    ramp_ms = cuda_ms(lambda: vwin.ramp_bpm(rx, FPS, cfg.band, r_first,
                                            r_last, out=r_out),
                      reps=5, inner=10, queue_ahead=True)
    ramp_plain = cuda_ms(lambda: vwin._ramp_bpm(rx, FPS, cfg.band, r_first,
                                                r_last))
    log(f"[time] ramp kernel at {T} x {RAMP_S} traces, lengths {r_first}.."
        f"{r_last}: {ramp_ms:.4f} ms, the queue filled ahead; plain "
        f"{ramp_plain:.3f} ms")

    # Least times for the timed work: bytes over 3.35 TB/s, operations (a
    # count per element, stated beside each) over 67 TFLOP/s.
    small = T * (12 + 4 + 16 + 2)          # K1's means, count, boxes, flags
    cheek = roi_bytes(clip_rois, H, W)
    sp, sh, sw = slot_frames.shape[:3]
    n6 = evm_run["n"]
    bounds = {
        # K1: every pixel read; 3 pooling adds per pixel and ~20 operations
        # per pooled cell's chroma test.
        "K1": bound(T * H * W * 3 + small + 48,
                    3 * T * H * W + 20 * T * (H // 8) * W),
        # K2, K3: the cheek ROIs' bytes, one add per byte.
        "K2": bound(cheek + T * (16 + 16), cheek),
        "K3": bound(cheek + T * (16 + 16), cheek),
        # K4: every slot's frame read; ~20 operations per pixel's test.
        "K4": bound(sp * sh * sw * 3 + sp * (24 + 4 + 34 + 24),
                    20 * sp * sh * sw),
        # K6: u8 frames in, f32 YIQ half-size planes out; ~170 operations
        # per output pixel (a 5x5 blur of 3 channels, the YIQ matrix).
        "K6": bound(evm_run["k6_bytes"], 170 * n6 * (H // 2) * (W // 2)),
        # K7: u8 frames and the f32 band in, u8 out; ~70 operations per
        # pixel (YIQ there and back, the bilinear taps, rounding).
        "K7": bound(evm_run["k7_bytes"], 70 * n6 * H * W),
        # K5: each stage's bf16 input and output and its weights per
        # launch; the operations of k5_ops, the 1x1 convs' in TF32 on the
        # tensor cores, the rest on the CUDA cores.
        "K5": bound(mp_run["k5"]["bytes"], mp_run["k5"]["ops"],
                    mp_run["k5"]["conv_ops"]),
        # The ramp: the traces in, bpm and valid out; two multiply-adds (re,
        # im) a stream for every in-band (k, n) pair.
        "R": bound(T * RAMP_S * 4 + (r_last - r_first + 1) * RAMP_S * 5,
                   4 * RAMP_S * ramp_pairs(FPS, cfg.band, r_first, r_last))}
    for k, (b_ms, by) in bounds.items():
        log(f"[bound] {k}: {b_ms:.4f} ms ({by})")
    log("[bound] K5 with every operation on the CUDA cores: %.4f ms (%s)"
        % bound(mp_run["k5"]["bytes"], mp_run["k5"]["ops"]))

    for mod in ("jax", "flatbuffers"):
        if mod in sys.modules:
            raise AssertionError(f"the port's smoke run imported {mod}")
    ref_mods = sorted(m for m in sys.modules
                      if m == "vhr_tpu" or m.startswith("vhr_tpu."))
    if ref_mods:
        raise AssertionError(f"the port's smoke run imported the JAX "
                             f"package: {ref_mods}")
    entries = [
        ("fused_detect_roi (K1)", "K1", "fused_detect.cu",
         "pallas_fused.py:385", k1_err, k1_ms, k1_plain),
        ("roi_channel_means (K2)", "K2", "roi_means.cu", "pallas_roi.py:167",
         k2_err, k2_ms, k2_plain),
        ("roi_channel_means_batched (K3)", "K3", "roi_means.cu",
         "pallas_roi.py:324", k3_err, k3_ms, k2_plain),
        ("fused_detect_roi_slots (K4)", "K4", "fused_slots.cu",
         "pallas_fused.py:479", k4_err, k4_ms, k4_plain),
        ("residual_stage (K5)", "K5", "residual_stage.cu",
         "pallas_meshblocks.py:152", mp_run["k5_err"], mp_run["k5"]["ms"],
         mp_run["k5"]["plain"]),
        ("yiq_pyrdown (K6)", "K6", "evm_pyrdown.cu", "pallas_evm.py:142",
         evm_checks["k6_err"], evm_run["k6_ms"], evm_run["k6_plain"]),
        ("evm_reconstruct (K7)", "K7", "evm_recon.cu",
         "pallas_evm_recon.py:147", evm_checks["k7_err"], evm_run["k7_ms"],
         evm_run["k7_plain"]),
        ("ramp_dft (the acquisition ramp)", "R", "ramp_dft.cu", None,
         ramp["err"], ramp_ms, ramp_plain)]
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": f"vhr_tpu_torch/csrc/{src}",
         "replaces": site and f"vhr_tpu/ops/{site}", "launches": launches[k],
         "max_abs_err": err, "ms": ms, "plain_ms": plain,
         "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
         "library_ms": None}
        for name, k, src, site, err, ms, plain in entries]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
