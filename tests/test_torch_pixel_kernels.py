"""The port's pixel kernels and detection stage against the reference.

Every output here is an integer, so equality is exact: the port's plain
versions of the fused cascade, the staged chain (framediff -> dilate ->
erode) and each stage alone must equal the reference's Pallas kernels (in
interpret mode, as the reference's own tests run them), its jnp twins and
the independent NumPy oracle ``ref.pixel_cascade_np``.  Connected
components, boxes and crops must equal the reference's too.  The CUDA
kernels are held against these plain versions on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic_video as RSV
from repro.detection import components as RC
from repro.detection import pipeline as RDP
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.data import synthetic_video as SV
from repro_torch.detection import components as C
from repro_torch.detection import pipeline as DP
from repro_torch.kernels import framediff as FD
from repro_torch.kernels import morphology as MO
from repro_torch.kernels import ops
from repro_torch.kernels import pixel_cascade as PC
from torch_kernel_cases import PIXEL_SHAPES, PIXEL_TILE_SHAPES, pixel_batch

#: (B, H, W): the default camera frame, sub-band, non-lane widths
FIXED_SHAPES = [(2, 96, 128), (1, 33, 40), (3, 16, 300), (2, 100, 96),
                (1, 64, 129)]


def _frames(rng, B, H, W):
    return rng.integers(0, 256, (3, B, H, W, 3)).astype(np.int32)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _port_both(fs, threshold):
    """The port's fused and staged cascades on the CPU; they must agree."""
    fused = ops.pixel_cascade(*fs, threshold=threshold, device="cpu")
    staged = ops.pixel_cascade(*fs, threshold=threshold, fused=False,
                               device="cpu")
    for a, b in zip(fused, staged):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert fused[0].dtype == fused[1].dtype == torch.int32
    return _np(fused[0]), _np(fused[1])


def _assert_vs_reference(fs, threshold, ref_modes=(True, False)):
    mask, counts = _port_both(fs, threshold)
    want_mask, want_counts = ref.pixel_cascade_np(*fs, threshold)
    np.testing.assert_array_equal(mask, want_mask)
    np.testing.assert_array_equal(counts, want_counts)
    for fused in ref_modes:
        jm, jc = jops.pixel_cascade(*(jnp.asarray(f) for f in fs),
                                    threshold=threshold, fused=fused)
        np.testing.assert_array_equal(mask, np.asarray(jm))
        np.testing.assert_array_equal(counts, np.asarray(jc))


@pytest.mark.parametrize("shape", FIXED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_cascade_matches_reference_fixed_shapes(shape):
    """Fused and staged == the reference's fused and staged Pallas
    launches == the NumPy oracle."""
    fs = _frames(np.random.default_rng(sum(shape)), *shape)
    _assert_vs_reference(fs, 40)


@pytest.mark.parametrize("case", range(12))
def test_cascade_seeded_sweep(case):
    """H across band multiples, W across lane multiples, thresholds across
    the range; the reference's fused and staged paths take turns."""
    rng = np.random.default_rng(700 + case)
    H = int(rng.integers(16, 140))
    W = int(rng.integers(16, 280))
    B = int(rng.integers(1, 4))
    thr = int(rng.integers(0, 250))
    _assert_vs_reference(_frames(rng, B, H, W), thr,
                         ref_modes=(case % 2 == 0,))


def _sparse_motion():
    B, H, W = 2, 96, 128
    base = np.full((B, H, W, 3), 30, np.int32)
    f0, f1, f2 = base.copy(), base.copy(), base.copy()
    f1[0, 40:56, 60:76] = 200        # camera 0 moves; camera 1 does not
    return f0, f1, f2


def test_sparse_motion_counts():
    fs = _sparse_motion()
    _assert_vs_reference(fs, 40)
    _, counts = _port_both(fs, 40)
    assert counts[0] > 0 and counts[1] == 0


def test_static_scene_is_empty():
    f = np.random.default_rng(3).integers(0, 256, (2, 40, 50, 3))
    mask, counts = _port_both((f, f, f), 0)
    assert not mask.any() and not counts.any()


@pytest.mark.parametrize("shape", FIXED_SHAPES[:3],
                         ids=lambda s: "x".join(map(str, s)))
def test_stages_match_reference(shape):
    """framediff, dilate3x3 and erode3x3 one at a time, against the
    reference's jnp twins, with uint8 frames as the renderer makes them."""
    rng = np.random.default_rng(11)
    fs = _frames(rng, *shape).astype(np.uint8)
    fd = ops.framediff(*fs, threshold=25, device="cpu")
    want_fd = ref.framediff_ref(*(jnp.asarray(f, jnp.int32) for f in fs),
                                25)
    np.testing.assert_array_equal(_np(fd), np.asarray(want_fd))
    x = rng.choice([0, 255], size=shape, p=[0.7, 0.3]).astype(np.int32)
    np.testing.assert_array_equal(_np(ops.dilate3x3(x, device="cpu")),
                                  np.asarray(ref.dilate3x3_ref(x)))
    np.testing.assert_array_equal(_np(ops.erode3x3(x, device="cpu")),
                                  np.asarray(ref.erode3x3_ref(x)))


def test_stages_match_reference_pallas():
    """The same three stages against the reference's Pallas launches."""
    rng = np.random.default_rng(12)
    fs = _frames(rng, 2, 40, 72)
    np.testing.assert_array_equal(
        _np(ops.framediff(*fs, threshold=30, device="cpu")),
        np.asarray(jops.framediff(*(jnp.asarray(f) for f in fs),
                                  threshold=30)))
    x = rng.choice([0, 255], size=(2, 40, 72), p=[0.6, 0.4]).astype(np.int32)
    np.testing.assert_array_equal(_np(ops.dilate3x3(x, device="cpu")),
                                  np.asarray(jops.dilate3x3(x)))
    np.testing.assert_array_equal(_np(ops.erode3x3(x, 255, device="cpu")),
                                  np.asarray(jops.erode3x3(x, 255)))


def test_cpu_calls_run_the_plain_versions_and_never_count():
    fs = [torch.from_numpy(f) for f in _frames(np.random.default_rng(0),
                                               1, 20, 24)]
    before = (FD.LAUNCHES, MO.LAUNCHES, PC.LAUNCHES)
    np.testing.assert_array_equal(
        _np(FD.framediff(*fs, threshold=40, maxval=255)),
        _np(FD.framediff_torch(*fs, threshold=40, maxval=255)))
    m = FD.framediff_torch(*fs, threshold=40, maxval=255)
    np.testing.assert_array_equal(_np(MO.dilate3x3(m)),
                                  _np(MO.morph3x3_torch(m, op="max", fill=0)))
    for a, b in zip(PC.pixel_cascade(*fs, threshold=40, maxval=255),
                    PC.pixel_cascade_torch(*fs, threshold=40, maxval=255)):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert (FD.LAUNCHES, MO.LAUNCHES, PC.LAUNCHES) == before


@pytest.mark.parametrize("shape", [PIXEL_SHAPES[0], PIXEL_SHAPES[4],
                                   *PIXEL_TILE_SHAPES[:3],
                                   PIXEL_TILE_SHAPES[6]],
                         ids=lambda s: "x".join(map(str, s)))
def test_cascade_reads_uint8_camera_views_like_the_reference(shape):
    """The uint8 views ``detect`` passes (``batch[:, k]`` of one (B, 3, H,
    W, 3) batch, a camera stride of three frames): the wrapper and
    ``ops.pixel_cascade`` equal the reference's plain cascade, also where
    f1 < f0 in a channel, which uint8 subtraction would wrap."""
    batch = pixel_batch(sum(shape), *shape)
    assert (batch[:, 1].astype(int) < batch[:, 0]).any()
    views = [torch.from_numpy(batch)[:, k] for k in range(3)]
    B, H, W = shape
    assert views[0].stride(0) == 3 * H * W * 3 and views[0].dtype == \
        torch.uint8
    want_mask, want_counts = jops.pixel_cascade(
        *(jnp.asarray(batch[:, k]) for k in range(3)), threshold=40,
        use_pallas=False)
    for mask, counts in (PC.pixel_cascade(*views, threshold=40, maxval=255),
                         ops.pixel_cascade(*views, device="cpu")):
        assert mask.dtype == counts.dtype == torch.int32
        np.testing.assert_array_equal(_np(mask), np.asarray(want_mask))
        np.testing.assert_array_equal(_np(counts), np.asarray(want_counts))


def test_plain_cascade_widens_uint8_before_subtracting():
    """The plain version on uint8 frames equals itself on the same frames
    in int32: it widens before it subtracts."""
    batch = torch.from_numpy(pixel_batch(5, 3, 33, 40))
    u8 = [batch[:, k] for k in range(3)]
    got = PC.pixel_cascade_torch(*u8, threshold=25, maxval=255)
    want = PC.pixel_cascade_torch(*(f.to(torch.int32) for f in u8),
                                  threshold=25, maxval=255)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b)
    assert int(got[1].sum()) > 0


def test_wrappers_refuse_what_the_kernels_do_not_take():
    f = torch.zeros((1, 8, 8, 3), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        PC.pixel_cascade(f.float(), f, f, threshold=40, maxval=255)
    with pytest.raises(TypeError, match="uint8 or int32"):
        PC.pixel_cascade(f.long(), f.long(), f.long(), threshold=40,
                         maxval=255)
    with pytest.raises(TypeError, match="one dtype"):
        PC.pixel_cascade(f.to(torch.uint8), f, f, threshold=40, maxval=255)
    with pytest.raises(ValueError, match="contiguous"):
        t = f.transpose(1, 2)                  # a camera's (H, W, 3) block
        PC.pixel_cascade(t, t, t, threshold=40, maxval=255)
    with pytest.raises(TypeError, match="int32"):
        FD.framediff(*(f.to(torch.uint8),) * 3, threshold=40, maxval=255)
    with pytest.raises(ValueError, match="one shape"):
        FD.framediff(f, f, f[:, :4], threshold=40, maxval=255)
    with pytest.raises(ValueError, match="op"):
        MO.morph3x3(f[..., 0], op="mean", fill=0)
    with pytest.raises(ValueError, match="int32"):
        MO.morph3x3(f[..., 0].float(), op="max", fill=0)


# --- connected components and detection --------------------------------------


def _two_blobs(B=2, H=24, W=40):
    m = np.zeros((B, H, W), np.int32)
    m[0, 2:7, 3:9] = 255
    m[0, 10:20, 20:35] = 255
    m[0, 19, 35:39] = 255             # a tail that joins blob 2 diagonally
    m[1, 5:6, 5:30] = 255             # an elongated one
    m[1, 0:3, 0:3] = 255              # in the corner
    return m


@pytest.mark.parametrize("kind", ["random", "blobs"])
def test_label_components_matches_reference(kind):
    if kind == "random":
        rng = np.random.default_rng(5)
        mask = (rng.uniform(size=(3, 20, 30)) < 0.35).astype(np.int32) * 255
    else:
        mask = _two_blobs()
    got = C.label_components(torch.from_numpy(mask))
    want = RC.label_components(jnp.asarray(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    for b in range(mask.shape[0]):
        assert [_box(x) for x in C.extract_boxes(_np(got)[b])] == \
            [_box(x) for x in RC.extract_boxes(np.asarray(want)[b])]


def _box(box):
    return (box.y0, box.x0, box.y1, box.x1, box.area)


def test_label_components_stops_at_max_iters():
    mask = np.zeros((1, 1, 40), np.int32)
    mask[0, 0, :] = 255               # one row: labels need 39 sweeps
    got = _np(C.label_components(torch.from_numpy(mask), max_iters=5))
    want = np.asarray(RC.label_components(jnp.asarray(mask), max_iters=5))
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1


def _busy_camera(seed, rate=2.0, sv=SV):
    cam = sv.make_cameras(1, seed=seed)[0]
    cam.base_rate, cam.busy_boost = rate, 0.0
    return cam


@pytest.mark.parametrize("fused", [True, False])
def test_detect_matches_reference(fused):
    """frames -> mask -> boxes -> crops: identical to the reference's
    detect (Pallas, interpret mode) on rendered frame triples."""
    rng = np.random.default_rng(0)
    frames, _ = SV.render_triple(_busy_camera(11), 0.0, rng)
    rframes, _ = RSV.render_triple(_busy_camera(11, sv=RSV), 0.0,
                                   np.random.default_rng(0))
    np.testing.assert_array_equal(frames, rframes)   # the same renderer
    got = DP.detect(frames, fused=fused, device="cpu")[0]
    want = RDP.detect(frames, fused=fused)[0]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert _box(g.box) == _box(w.box)
        np.testing.assert_array_equal(g.crop, w.crop)


def test_detect_batch_matches_reference():
    rng = np.random.default_rng(4)
    batch = np.stack([SV.render_triple(_busy_camera(20 + j, 3.0), 0.0,
                                       rng)[0] for j in range(3)])
    got = DP.detect(batch, device="cpu")
    want = RDP.detect(batch)
    assert [len(d) for d in got] == [len(d) for d in want]
    for gd, wd in zip(got, want):
        for g, w in zip(gd, wd):
            assert _box(g.box) == _box(w.box)
            np.testing.assert_array_equal(g.crop, w.crop)


def test_static_scene_runs_no_ccl(monkeypatch):
    """A motionless tick never reaches the CCL fixpoint."""
    def boom(*a, **k):
        raise AssertionError("CCL ran on a motionless tick")

    monkeypatch.setattr(C, "label_components", boom)
    f = np.full((2, 3, 48, 64, 3), 90, np.uint8)
    assert DP.detect(f, device="cpu") == [[], []]
    mask = DP.motion_mask(f[:, 0], f[:, 1], f[:, 2], device="cpu")
    assert mask.shape == (2, 48, 64) and not bool(mask.any())
