"""Port parity for the production MediaPipe face detector: the TFLite reader,
the executor, kernel K5's plain version, the graph logic around the nets,
the detector and the offline measure driven by it, against ``vhr_tpu``.

The same numpy inputs go to both packages; JAX runs on the CPU, its Pallas
K5 in interpret mode.  Tolerances and why:

* the parse, anchors, validity flags: equal;
* executors, float32, output / max(max|ref|, 1): 2e-5 for BlazeFace and
  3e-4 for the mesh net (the JAX package's own bounds,
  ``tests/test_mediapipe_face.py``; summation order over deep nets);
* K5's plain version against the Pallas kernel: float32 within
  ``1e-5 * max|y|``; bfloat16 within one bf16 ulp of each value or
  ``1e-5 * max|y|`` where that is larger (near zero the float32 rounding
  order alone decides the last bit);
* graph-logic units: float32 rounding of the same expressions (each test
  states its bound);
* detector: float32 boxes within 1 px (landmarks agree to ~1e-4 px, and a
  landmark on an integer boundary can still truncate either way), bf16
  activations landmark RMS <= 1 px (each package rounds its bf16 maps in
  its own order);
* the measure on a pulsed clip: validity equal, green within 1e-4, BPM
  within 1e-3 on valid frames.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vhr_tpu import config as jconfig
from vhr_tpu.models import mediapipe_face as jmp
from vhr_tpu.models import tflite as jtflite
from vhr_tpu.models import tflite_exec as jexec
from vhr_tpu.ops import pallas_meshblocks as jmb
from vhr_tpu.pipeline import offline as joffline

from vhr_tpu_torch import interop
from vhr_tpu_torch.config import PipelineConfig
from vhr_tpu_torch.models import mediapipe_face as tmp
from vhr_tpu_torch.models import tflite as ttflite
from vhr_tpu_torch.models import tflite_exec as texec
from vhr_tpu_torch.ops import meshblocks_cuda as tmb
from vhr_tpu_torch.pipeline import offline as toffline
from vhr_tpu_torch.utils.profiling import counter, reset_counters

# One intra-op thread: the suite runs several pytest workers on the
# host's cores, and more threads a worker oversubscribe them.
torch.set_num_threads(1)

TASK = tmp.default_task_path()
DET, MESH = "face_detector.tflite", "face_landmarks_detector.tflite"
CPU = torch.device("cpu")


def draw_face(H=256, W=320, cx=160, cy=130, rx=55, ry=75):
    """The schematic face of ``tests/test_mediapipe_face.py`` (BlazeFace
    scores it ~0.84)."""
    import cv2
    img = np.full((H, W, 3), (60, 70, 80), np.uint8)
    cv2.ellipse(img, (cx, cy), (rx, ry), 0, 0, 360, (130, 165, 200), -1)
    cv2.ellipse(img, (cx, cy - ry + 18), (rx - 6, 26), 0, 180, 360,
                (40, 60, 80), -1)
    for ex in (cx - 22, cx + 22):
        cv2.circle(img, (ex, cy - 15), 9, (255, 255, 255), -1)
        cv2.circle(img, (ex, cy - 15), 5, (40, 30, 30), -1)
        cv2.line(img, (ex - 12, cy - 30), (ex + 12, cy - 32),
                 (50, 50, 60), 3)
    cv2.line(img, (cx, cy - 5), (cx - 6, cy + 14), (90, 120, 150), 3)
    cv2.ellipse(img, (cx, cy + 34), (18, 9), 0, 0, 180, (60, 60, 120), 3)
    return img


@pytest.fixture(scope="module")
def models():
    return ttflite.load_task_models(TASK), jtflite.load_task_models(TASK)


def _graph(models, name, which=0):
    return copy.deepcopy(models[which][name].graph)


def _close(got, want, atol):
    """Output / max(max|want|, 1) within ``atol``, shapes equal."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol)


def _k5_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    big = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-30)
    ulp = np.exp2(np.floor(np.log2(big)) - 7)
    assert np.all(err <= np.maximum(ulp, 1e-5 * scale)), float(
        (err / np.maximum(ulp, 1e-5 * scale)).max())


# --- (a) the parse, (b) the stages -----------------------------------------

@pytest.mark.parametrize("name", [DET, MESH, "face_blendshapes.tflite"])
def test_parse_equals_jax(models, name):
    """The struct reader's parse equals the flatbuffers-based one: every
    tensor's name, shape, dtype, data and quantisation, every op's name,
    inputs, outputs and options."""
    ours, ref = models[0][name], models[1][name]
    assert list(models[0]) == list(models[1])
    assert ours.description == ref.description
    assert len(ours.subgraphs) == len(ref.subgraphs)
    for g, r in zip(ours.subgraphs, ref.subgraphs):
        assert (g.name, g.inputs, g.outputs) == (r.name, r.inputs, r.outputs)
        assert len(g.tensors) == len(r.tensors)
        for t, u in zip(g.tensors, r.tensors):
            assert (t.name, t.shape, t.dtype) == (u.name, u.shape, u.dtype)
            for a, b in ((t.data, u.data), (t.quant_scale, u.quant_scale),
                         (t.quant_zero, u.quant_zero)):
                assert (a is None) == (b is None)
                if a is not None:
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
        assert [(o.op, o.inputs, o.outputs, o.options)
                for o in g.operators] == \
            [(o.op, o.inputs, o.outputs, o.options) for o in r.operators]


def test_residual_stages_equal_jax(models):
    g = texec.fold_dequantize(_graph(models, MESH, 0))
    r = jexec.fold_dequantize(_graph(models, MESH, 1))
    ours = texec._find_residual_stages(g.operators, g.tensors)
    ref = jexec._find_residual_stages(r.operators, r.tensors)
    assert ours == ref
    assert [(s["H"], s["C"], len(s["blocks"])) for s in ours] == [
        (128, 16, 4), (64, 32, 4), (32, 64, 4), (16, 128, 4)]
    assert sum(s["n_ops"] for s in ours) == 100
    assert texec.SUPPORTED_OPS == jexec.SUPPORTED_OPS


# --- (c) K5's plain version against the Pallas kernel ----------------------

def _random_stage(rng, C, Cm, n=4):
    """TFLite-layout stage weights scaled so the maps stay O(1)."""
    g = lambda *s, sc=1.0: rng.normal(0, sc, s).astype(np.float32)
    blocks = [dict(w1=g(Cm, 1, 1, C, sc=C ** -0.5), b1=g(Cm, sc=0.1),
                   a1=rng.uniform(0, 0.5, (1, 1, Cm)).astype(np.float32),
                   dw=g(1, 3, 3, Cm, sc=1 / 3), bdw=g(Cm, sc=0.1),
                   w2=g(C, 1, 1, Cm, sc=Cm ** -0.5), b2=g(C, sc=0.1),
                   a2=rng.uniform(0, 0.5, (1, 1, C)).astype(np.float32))
              for _ in range(n)]
    return rng.uniform(0, 0.5, (1, 1, C)).astype(np.float32), blocks


def _real_stage(models, idx):
    g = texec.fold_dequantize(_graph(models, MESH, 0))
    st = texec._find_residual_stages(g.operators, g.tensors)[idx]
    blocks = [{k: g.tensors[t].data for k, t in b.items()}
              for b in st["blocks"]]
    return st, g.tensors[st["a0"]].data, blocks


def _k5_pair(a0, blocks, x, w_row, dtype):
    want = jmb.residual_stage_pallas(
        jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16" else
                              jnp.float32),
        jmb.pack_stage_weights(a0, blocks), w_row, interpret=True)
    xt = torch.as_tensor(x)
    if dtype == "bf16":
        xt = xt.to(torch.bfloat16)
    got = tmb.residual_stage(xt, tmb.pack_stage_weights(a0, blocks), w_row)
    assert got.dtype == xt.dtype and tuple(got.shape) == x.shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("H,W,C,Cm", [(4, 32, 16, 8), (8, 16, 32, 16)])
def test_k5_plain_matches_pallas_random(H, W, C, Cm, dtype):
    """Random weights at shapes whose bands are all edge: every row and
    column meets the SAME padding."""
    rng = np.random.default_rng(H * W + C)
    a0, blocks = _random_stage(rng, C, Cm)
    x = rng.normal(0, 1, (2, C, H * W)).astype(np.float32)
    got, want = _k5_pair(a0, blocks, x, W, dtype)
    if dtype == "f32":
        _close(got / np.abs(want).max(), want / np.abs(want).max(), 1e-5)
    else:
        _k5_close(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("stage", [2, 3])
def test_k5_plain_matches_pallas_real_weights(models, stage, dtype):
    """The bundled mesh net's stages 3 (32x32, C=64) and 4 (16x16, C=128)
    with their packed weights, B=1."""
    st, a0, blocks = _real_stage(models, stage)
    rng = np.random.default_rng(stage)
    x = rng.normal(0, 1, (1, st["C"], st["H"] * st["W"])).astype(np.float32)
    got, want = _k5_pair(a0, blocks, x, st["W"], dtype)
    if dtype == "f32":
        _close(got / np.abs(want).max(), want / np.abs(want).max(), 1e-5)
    else:
        _k5_close(got, want)


def test_k5_contract():
    """The JAX kernel's shape contract: S a multiple of 128; the plain
    version is the wrapper's route for CPU tensors; the CUDA kernel's
    shapes are refused by name where it is not built for them; the band
    geometry holds each stage of the mesh net, weights included, in the
    card's shared memory."""
    a0, blocks = _random_stage(np.random.default_rng(0), 16, 8)
    wts = tmb.pack_stage_weights(a0, blocks)
    with pytest.raises(ValueError, match="multiple of 128"):
        tmb.residual_stage(torch.zeros(1, 16, 96), wts, 8)
    x = torch.as_tensor(np.random.default_rng(1).normal(
        size=(2, 16, 256)).astype(np.float32))
    reset_counters("k5.launches")
    torch.testing.assert_close(tmb.residual_stage(x, wts, 16),
                               tmb.residual_stage_plain(x, wts, 16),
                               rtol=0, atol=0)
    assert counter("k5.launches") == 0
    for C, Cm, w_row in [(24, 8, 16), (16, 4, 16), (256, 128, 16)]:
        with pytest.raises(ValueError, match="C = 2 \\* Cm"):
            tmb.check_kernel_shape(C, Cm, w_row)
    with pytest.raises(ValueError, match="w_row=6"):
        tmb.check_kernel_shape(16, 8, 6)
    for Cm in tmb.KERNEL_TILING:
        tmb.check_kernel_shape(2 * Cm, Cm, 16)
    # The band geometry of the four stages: rows a thread block, its
    # shared memory and the planes' stride.  The memory counts both planes
    # and one block's weights; every stage fits; the smallest map, whose
    # frame with a conv's split weights does not, is cut into two bands.
    got = [tmb.stage_rows(c, c // 2, h, h, 4, SMEM,
                          16 * tmb.KERNEL_TILING[c // 2][0])
           for c, h in MESH_STAGES]
    assert got == [(10, 223488, 2312), (10, 227840, 1160),
                   (8, 218112, 520), (8, 223232, 200)]
    for (c, h), (rows, smem, stride) in zip(MESH_STAGES, got):
        assert smem == 4 * (c * 3 // 2 * stride
                            + tmb.weight_floats(c, c // 2)) <= SMEM
        assert smem > 4 * c * 3 // 2 * h * min(h, rows + 8)
    assert -(-16 // got[3][0]) >= 2
    assert 4 * (192 * tmb.plane_stride(256, 16)
                + tmb.weight_floats(128, 64)) > SMEM
    with pytest.raises(ValueError, match="does not fit"):
        tmb.stage_rows(128, 64, 16, 16, 4, 100000)


SMEM = 232448                # an H100's opt-in shared memory per block
MESH_STAGES = [(16, 128), (32, 64), (64, 32), (128, 16)]    # (C, H = W)


@pytest.mark.parametrize("C,H", MESH_STAGES + [(16, 4), (32, 8)])
def test_k5_bands_cover_the_frame(C, H):
    """K5's bands write every row once, hold their rows plus four halo rows
    a side clipped to the frame, and none holds more than ``stage_rows``
    sized the shared memory for."""
    n = 4
    tile = 16 * tmb.KERNEL_TILING[C // 2][0]
    W = H if H >= 16 else 32 if H == 4 else 16
    rows, smem, stride = tmb.stage_rows(C, C // 2, H, W, n, SMEM, tile)
    bands = [tmb.band_rows(H, rows, n, b) for b in range(-(-H // rows))]
    assert [b[0] for b in bands] == list(range(0, H, rows))
    assert [b[1] for b in bands] == [b[0] for b in bands[1:]] + [H]
    for r0, r1, lo, hi in bands:
        assert (lo, hi) == (max(0, r0 - n), min(H, r1 + n))
        assert (hi - lo) * W <= stride
        # after n blocks the rows still current are the band's own
        vlo, vhi = lo, hi
        for _ in range(n):
            vlo, vhi = vlo + (vlo > 0), vhi - (vhi < H)
        assert vlo <= r0 and vhi >= r1
    assert smem == 4 * (C * 3 // 2 * stride + tmb.weight_floats(C, C // 2))


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("pixels", [192, 512, 1152, 2304, 128, 120, 1000])
def test_k5_plane_stride(pixels, tile):
    """A plane holds the pixels in whole tiles, 16-byte aligned, and its
    stride is 8 modulo 32 words: lane (g, t) of a warp reads channel t's
    pixels ``np * g ...`` (np = tile / 8 a lane), and the 32 lanes' words
    fall into 32 different banks, ``np`` at a time."""
    stride = tmb.plane_stride(pixels, tile)
    assert stride % 32 == 8 and stride % 4 == 0
    assert -(-pixels // tile) * tile <= stride < pixels + tile + 32
    np_ = tile // 8
    lanes = 32 // np_            # lanes served at once by a vector access
    banks = {(t * stride + np_ * g + i) % 32
             for g in range(lanes // 4) for t in range(4)
             for i in range(np_)}
    assert len(banks) == 32


def test_k5_weight_floats():
    """One conv's matrix as big and small parts, nine taps, and the
    biases and slopes b1, a1, bdw (Cm each), b2, a2 (C each)."""
    assert tmb.weight_floats(128, 64) == 2 * 128 * 64 + 12 * 64 + 2 * 128
    assert tmb.weight_floats(16, 8) == 256 + 96 + 32


# --- (d) the executors -----------------------------------------------------

def _run_jax(graph, x, **kw):
    params, apply = jexec.build_jax(graph, **kw)
    return [np.asarray(y) for y in jax.jit(apply)(params, jnp.asarray(x))]


def _run_torch(graph, x, **kw):
    params, apply = texec.build_torch(graph, device=CPU, **kw)
    return [y.numpy() for y in apply(params, torch.as_tensor(x))], apply


@pytest.fixture(scope="module")
def mesh_ref(models):
    x = np.random.default_rng(2).uniform(0, 1, (1, 256, 256, 3)) \
        .astype(np.float32)
    return x, _run_jax(_graph(models, MESH, 1), x)


def test_blazeface_matches_jax(models):
    x = np.random.default_rng(0).uniform(-1, 1, (1, 128, 128, 3)) \
        .astype(np.float32)
    got, _ = _run_torch(_graph(models, DET), x)
    for a, b in zip(got, _run_jax(_graph(models, DET, 1), x)):
        _close(a, b, 2e-5)


@pytest.mark.parametrize("fuse", [False, True])
def test_mesh_matches_jax(models, mesh_ref, fuse):
    """The mesh net, unfused and with its four stages on K5's plain
    version, against the unfused JAX executor."""
    x, ref = mesh_ref
    got, apply = _run_torch(_graph(models, MESH), x, fuse_stages=fuse)
    assert len(apply.stages) == (4 if fuse else 0)
    for a, b in zip(got, ref):
        _close(a, b, 3e-4)


@pytest.mark.parametrize("name,lo,tol", [(DET, -1.0, 2e-5),
                                         (MESH, 0.0, 3e-4)])
def test_executor_matches_own_numpy_oracle(models, name, lo, tol):
    size = 128 if name == DET else 256
    x = np.random.default_rng(5).uniform(lo, 1, (1, size, size, 3)) \
        .astype(np.float32)
    got, _ = _run_torch(_graph(models, name), x)
    for a, b in zip(got, texec.NumpyInterpreter(_graph(models, name))(x)):
        _close(a, b, tol)


def test_numpy_oracle_equals_jax_package(models):
    x = np.random.default_rng(6).uniform(-1, 1, (1, 128, 128, 3)) \
        .astype(np.float32)
    for a, b in zip(texec.NumpyInterpreter(_graph(models, DET))(x),
                    jexec.NumpyInterpreter(_graph(models, DET, 1))(x)):
        np.testing.assert_array_equal(a, b)


def test_reshape_batch_scaling_matches_jax(models):
    """B=3 through both nets: BlazeFace's batch-1 (1,512,16) reshapes and
    the mesh net's (-1, 1) presence reshape scale to the batch."""
    rng = np.random.default_rng(3)
    for name, size, lo in ((DET, 128, -1.0), (MESH, 256, 0.0)):
        x = rng.uniform(lo, 1, (3, size, size, 3)).astype(np.float32)
        got, _ = _run_torch(_graph(models, name), x)
        ref = _run_jax(_graph(models, name, 1), x)
        assert [a.shape[0] for a in got] == [3] * len(got)
        for a, b in zip(got, ref):
            _close(a, b, 2e-5 if name == DET else 3e-4)


def _reshape_graph(pkg, target):
    """input (1,2,2,4) -> RESHAPE(new_shape=target)."""
    T = pkg.Tensor
    tensors = [T("x", (1, 2, 2, 4), np.float32, None),
               T("y", tuple(target), np.float32, None)]
    op = pkg.Operator("RESHAPE", [0], [1], {"new_shape": tuple(target)})
    return pkg.Subgraph("r", tensors, [0], [1], [op])


@pytest.mark.parametrize("target,match", [((2, 8), "batch-agnostic"),
                                          ((1, 5), "not divisible")])
def test_reshape_errors_match_jax(target, match):
    x = np.zeros((3, 2, 2, 4), np.float32)
    with pytest.raises(ValueError, match=match):
        _run_jax(_reshape_graph(jtflite, target), x)
    with pytest.raises(ValueError, match=match):
        _run_torch(_reshape_graph(ttflite, target), x)


# --- (e) the graph-logic units ---------------------------------------------

@pytest.mark.parametrize("shape", [(2, 90, 160), (1, 200, 120)])
def test_letterbox_matches_jax(shape):
    rng = np.random.default_rng(shape[1])
    frames = rng.integers(0, 256, shape + (3,), np.uint8)
    ref = jmp._letterbox(jnp.asarray(frames), 128, -1.0, 1.0)
    got = tmp._letterbox(torch.as_tensor(frames), 128, -1.0, 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-5)
    ref = jmp._letterbox(jnp.asarray(frames), 128, 0.0, 1.0, jnp.bfloat16)
    got = tmp._letterbox(torch.as_tensor(frames), 128, 0.0, 1.0,
                         torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # bf16 products and sums: within 2^-7 of values in [0, 1].
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), rtol=0,
                               atol=2 ** -7)


def _raw_detections(rng, T=3):
    """Raw SSD outputs with a few strong, overlapping candidates per
    frame."""
    reg = rng.normal(0, 2, (T, 896, 16)).astype(np.float32)
    reg[..., 2:4] = rng.uniform(5, 40, (T, 896, 2))
    cls = rng.normal(-6, 3, (T, 896, 1)).astype(np.float32)
    cls[:, 100:106, 0] = rng.uniform(0, 8, (T, 6))
    reg[:, 100:106, 2:4] = 30.0
    return reg, cls


def test_decode_and_nms_match_jax():
    rng = np.random.default_rng(4)
    reg, cls = _raw_detections(rng)
    anchors = jmp.blazeface_anchors()
    jb, js, jk = jmp._decode_detections(jnp.asarray(reg), jnp.asarray(cls),
                                        jnp.asarray(anchors))
    tb, ts, tk = tmp._decode_detections(torch.as_tensor(reg),
                                        torch.as_tensor(cls),
                                        torch.as_tensor(anchors))
    for a, b in ((tb, jb), (ts, js), (tk, jk)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    low = ts.numpy() * 0.1
    for k in (1, 2):
        for scores in (ts.numpy(), low):
            ref = jax.vmap(lambda b, s, kp: jmp._weighted_nms(
                b, s, kp, k_faces=k))(jb, jnp.asarray(scores), jk)
            got = tmp._weighted_nms(tb, torch.as_tensor(scores), tk, k)
            np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
            for a, b in zip(got[:3], ref[:3]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-6)
            if scores is low:
                assert not got[3].any()


def test_detection_to_rect_and_projection_match_jax():
    rng = np.random.default_rng(8)
    box = rng.uniform(0.2, 0.8, (4, 2, 4)).astype(np.float32)
    kps = rng.uniform(0.2, 0.8, (4, 2, 6, 2)).astype(np.float32)
    for H, W in ((256, 320), (1080, 1920)):
        ref = jmp._detection_to_rect(jnp.asarray(box), jnp.asarray(kps), H, W)
        got = tmp._detection_to_rect(torch.as_tensor(box),
                                     torch.as_tensor(kps), H, W)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)
    lm = rng.uniform(0, 256, (4, 2, 478, 3)).astype(np.float32)
    ref = jax.vmap(jax.vmap(jmp._project_landmarks))(jnp.asarray(lm), ref)
    got = tmp._project_landmarks(torch.as_tensor(lm), got)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-3)
    px = np.concatenate([rng.uniform(-30, 2000, (4, 478, 1)),
                         rng.uniform(-30, 1200, (4, 478, 1))], -1) \
        .astype(np.float32)
    px[0] = np.round(px[0])               # landmarks on integer boundaries
    np.testing.assert_array_equal(
        tmp._landmarks_to_bbox(torch.as_tensor(px), 1080, 1920).numpy(),
        np.asarray(jmp._landmarks_to_bbox(jnp.asarray(px), 1080, 1920)))


# Rects (cx, cy, side, rot) over a 97x133 frame: interior, rotated, spilling
# over every edge, larger than the frame, fully outside.
_RECTS = [(60.0, 50.0, 40.0, 0.0), (60.0, 50.0, 40.0, 0.37),
          (2.0, 3.0, 50.0, 0.5), (131.0, 95.0, 60.0, -0.4),
          (66.0, 48.0, 400.0, 0.25), (-20.0, -10.0, 30.0, 0.1)]


def _rects(rot=True):
    a = np.asarray(_RECTS, np.float32).T.reshape(4, 2, 3)   # (T=2, K=3)
    if not rot:
        a[3] = 0.0
    return a


@pytest.mark.parametrize("mode", ["exact", "axis"])
def test_crops_match_jax(mode):
    """Both crop modes against the JAX package's: the exact crop against
    its 4-tap ``_crop_rotated_ref`` (bit-exact with its packed form), the
    axis crop against ``_crop_axis_mxu``, per frame and face."""
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (2, 97, 133, 3), np.uint8)
    r = _rects(rot=mode == "exact")
    got = tmp._crop_faces(torch.as_tensor(frames),
                          tmp._Rect(*torch.as_tensor(r)), 48,
                          mode=mode).numpy()
    fn = jmp._crop_rotated_ref if mode == "exact" else jmp._crop_axis_mxu
    for t in range(2):
        for k in range(3):
            rect = jmp._Rect(*(jnp.float32(v) for v in r[:, t, k]))
            ref = np.asarray(fn(jnp.asarray(frames[t]), rect, 48))
            # The packages' float32 cos/sin differ by an ulp or two; times
            # a side of up to 400 px that moves a sample ~1e-4 px, and a
            # full-range u8 step between taps turns it into ~1e-4 here.
            np.testing.assert_allclose(got[t, k], ref, rtol=0, atol=2e-4)


def test_axis_crop_bf16_matches_jax():
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, (2, 97, 133, 3), np.uint8)
    r = _rects(rot=False)
    got = tmp._crop_axis_mxu(torch.as_tensor(frames),
                             tmp._Rect(*torch.as_tensor(r)), 48,
                             torch.bfloat16)
    assert got.dtype == torch.bfloat16
    for t in range(2):
        for k in range(3):
            rect = jmp._Rect(*(jnp.float32(v) for v in r[:, t, k]))
            ref = jmp._crop_axis_mxu(jnp.asarray(frames[t]), rect, 48,
                                     jnp.bfloat16).astype(jnp.float32)
            # bf16 storage of values in [0, 1]: within 2^-7.
            np.testing.assert_allclose(got[t, k].float().numpy(),
                                       np.asarray(ref), rtol=0, atol=2 ** -7)


# --- (f) the detector, (h) weights from the JAX package --------------------

@pytest.fixture(scope="module")
def face_frames():
    img = draw_face()
    noise = np.random.default_rng(0).integers(0, 255, img.shape, np.uint8)
    return np.stack([img, noise])


@pytest.mark.parametrize("activation", ["f32", "bf16"])
def test_detector_matches_jax(face_frames, activation):
    kw = {"activation_dtype": None} if activation == "f32" else {}
    jdet = jmp.make_mediapipe_detector(TASK, **kw)
    jb, jv = jax.jit(lambda f: jdet(f))(jnp.asarray(face_frames))
    det = tmp.make_mediapipe_detector(TASK, device="cpu", **kw)
    tb, tv = det(torch.as_tensor(face_frames))
    assert tb.dtype == torch.int32 and tv.dtype == torch.bool
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.tolist() == [True, False]          # the face; noise has none
    np.testing.assert_array_equal(tb[1].numpy(), [0, 0, 0, 0])
    if activation == "f32":
        assert np.abs(tb.numpy() - np.asarray(jb)).max() <= 1
        return
    fr = face_frames[:1]
    jlm, _, _ = _jax_landmarks(fr, jnp.bfloat16, "axis")
    tp, tda, tla = tmp.load_face_models(TASK, activation_dtype=torch.bfloat16,
                                        device="cpu")
    tr, _, _ = tmp.detect_faces_mp(tp, tda, torch.as_tensor(fr))
    tlm, _ = tmp.face_landmarks(tp, tla, torch.as_tensor(fr), tr)
    rms = float(np.sqrt(np.mean((tlm.numpy() - np.asarray(jlm)) ** 2)))
    assert rms <= 1.0, rms


def _jax_landmarks(frames, activation_dtype, crop_mode):
    """The JAX package's detector stages, jitted: (landmarks, presence,
    detection ok)."""
    jp, jda, jla = jmp.load_face_models(TASK,
                                        activation_dtype=activation_dtype)

    def run(fr):
        rects, _, ok = jmp.detect_faces_mp(jp, jda, fr)
        return jmp.face_landmarks(jp, jla, fr, rects,
                                  crop_mode=crop_mode) + (ok,)
    return jax.jit(run)(jnp.asarray(frames))


def test_exact_crop_detector_matches_jax(face_frames):
    fr = face_frames[:1]
    jlm, jpr, jok = _jax_landmarks(fr, None, "exact")
    tp, tda, tla = tmp.load_face_models(TASK, device="cpu")
    tr, _, tok = tmp.detect_faces_mp(tp, tda, torch.as_tensor(fr))
    tlm, tpr = tmp.face_landmarks(tp, tla, torch.as_tensor(fr), tr,
                                  crop_mode="exact")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tlm.numpy(), np.asarray(jlm), rtol=0,
                               atol=1e-2)
    np.testing.assert_allclose(tpr.numpy(), np.asarray(jpr), atol=1e-5)


def test_fused_detector_matches_unfused(face_frames):
    """The mesh net with its stages on K5's plain version: the same boxes
    as the unfused nets, in float32 and in bf16 activations."""
    fr = torch.as_tensor(face_frames)
    for ad in (None, torch.bfloat16):
        outs = []
        for fuse in (False, True):
            p, da, la = tmp.load_face_models(TASK, activation_dtype=ad,
                                             fuse_stages=fuse, device="cpu")
            assert len(la.stages) == (4 if fuse else 0)
            outs.append(tmp._detect_single(p, da, la, fr))
        assert torch.equal(outs[0][1], outs[1][1])
        assert int((outs[0][0] - outs[1][0]).abs().max()) <= 1


@pytest.mark.parametrize("fuse", [False, True])
def test_face_params_from_jax(face_frames, fuse):
    """The JAX package's weights carried into the port run the port's nets
    to the same outputs as the port's own load; a wrong key set raises."""
    jp, _, _ = jmp.load_face_models(TASK, fuse_stages=fuse)
    leaves = (jax.tree.map(np.asarray, jp.det),
              jax.tree.map(np.asarray, jp.lm))
    params = interop.face_params_from_jax(*leaves, device="cpu")
    own, da, la = tmp.load_face_models(TASK, fuse_stages=fuse, device="cpu")
    assert set(params.lm) == set(own.lm)
    for k, v in own.lm.items():
        torch.testing.assert_close(params.lm[k], v, rtol=0, atol=0)
    fr = torch.as_tensor(face_frames)
    a = tmp._detect_single(params, da, la, fr)
    b = tmp._detect_single(own, da, la, fr)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    bad = dict(leaves[0])
    bad["99999"] = bad.pop(sorted(bad)[0])
    with pytest.raises(ValueError, match="detector params differ"):
        interop.face_params_from_jax(bad, leaves[1], device="cpu")


# --- (g) the slice as a whole ----------------------------------------------

_CFG_ARGS = dict(window_seconds=1.0, acquisition_seconds=0.5)


@pytest.fixture(scope="module")
def pulsed_clip():
    """T=48 frames of the drawn face at 192x224 with a 1.25 Hz green pulse
    on the skin ellipse (``tests/test_mediapipe_face.py``'s pipeline
    clip)."""
    fps, T = 30.0, 48
    img = draw_face(H=192, W=224, cx=112, cy=96, rx=45, ry=62)
    pulse = 3.0 * np.sin(2 * np.pi * 1.25 * np.arange(T) / fps)
    frames = np.repeat(img[None], T, axis=0).astype(np.float32)
    ys, xs = np.mgrid[0:192, 0:224]
    skin = ((xs - 112) / 45.0) ** 2 + ((ys - 96) / 62.0) ** 2 <= 1.0
    frames[:, skin, 1] += pulse[:, None]
    return np.clip(frames, 0, 255).astype(np.uint8), fps


@pytest.mark.parametrize("detect_every", [1, 4])
def test_mediapipe_measure_matches_jax(pulsed_clip, detect_every):
    """``measure_green_avg(detector=mediapipe)`` and its green trace, port
    against JAX, float32 nets."""
    frames, fps = pulsed_clip
    jcfg, cfg = jconfig.PipelineConfig(**_CFG_ARGS), \
        PipelineConfig(**_CFG_ARGS)
    jdet = jmp.make_mediapipe_detector(TASK, activation_dtype=None)
    tdet = tmp.make_mediapipe_detector(TASK, activation_dtype=None,
                                       device="cpu")
    jtr = joffline.extract_signals(jnp.asarray(frames), jcfg, detector=jdet,
                                   detect_every=detect_every)
    ttr = toffline.extract_signals(torch.as_tensor(frames), cfg,
                                   detector=tdet, detect_every=detect_every)
    np.testing.assert_array_equal(ttr.valid.numpy(), np.asarray(jtr.valid))
    assert ttr.valid.numpy().mean() > 0.9
    np.testing.assert_allclose(ttr.bgr.numpy(), np.asarray(jtr.bgr),
                               rtol=0, atol=1e-4)
    _, jbpm, jval = joffline.measure_green_avg(
        jnp.asarray(frames), fps, jcfg, detector=jdet,
        detect_every=detect_every)
    _, tbpm, tval = toffline.measure_green_avg(
        torch.as_tensor(frames), fps, cfg, detector=tdet,
        detect_every=detect_every)
    np.testing.assert_array_equal(tval, np.asarray(jval))
    assert tval.sum() > 0
    np.testing.assert_allclose(tbpm[tval], np.asarray(jbpm)[tval], rtol=0,
                               atol=1e-3)
