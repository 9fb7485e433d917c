"""The port's CUDA wrappers on the card: launch counters, refusals, and
short runs.  ``chip_smoke.py`` holds each kernel against its plain version
at the edge-case and main-path shapes; this file does not repeat that.

Every test here needs a CUDA device and carries the ``cuda`` marker; on a
host without one they skip.  The file imports nothing of JAX or the
reference package, so it also runs on a GPU machine that has neither:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.system as P
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.core.thresholds import ThresholdState
from repro_torch.kernels import calibrate as C
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import morphology as MO
from repro_torch.kernels import ops
from repro_torch.kernels import pixel_cascade as PC
from repro_torch.kernels import similarity as SIM
from repro_torch.kernels import superstep as SS
from repro_torch.kernels import triage as T
from repro_torch.models import meta as M
from repro_torch.serving.engine import CascadeServer, Request
from torch_kernel_cases import (ASSOC_CASES, CALIBRATE_WIDTHS,
                                PIXEL_SHAPES, PIXEL_TILE_SHAPES,
                                SUPERSTEP_WIDTH_CASES, TRIAGE_ROWS,
                                TRIAGE_WIDTHS, label_case, pixel_batch,
                                superstep_slab, triage_case)

pytestmark = pytest.mark.cuda

#: calibrate params, kernel against plain version: ``chip_smoke.CAL_ATOL``
#: (both f32 Newton fits of one function, the sums in another order)
CAL_ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _fleet(seed, rows, n):
    rng = np.random.default_rng(seed)
    conf = rng.uniform(0, 1, (rows, n)).astype(np.float32)
    conf[0] = -1.0                                   # an all-pad row
    thr = np.stack([rng.uniform(0.5, 1.0, rows), rng.uniform(0.0, 0.45, rows)],
                   axis=1).astype(np.float32)
    return torch.from_numpy(conf), torch.from_numpy(thr)


def _labels(seed, lengths, n):
    rng = np.random.default_rng(seed)
    scores = np.full((len(lengths), n), -1.0, np.float32)
    truths = np.zeros((len(lengths), n), np.float32)
    for e, length in enumerate(lengths):
        s = rng.uniform(0.02, 0.98, length)
        p = 1.0 / (1.0 + np.exp(-(2.0 * np.log(s / (1 - s)) + 0.5)))
        scores[e, :length] = s
        truths[e, :length] = rng.uniform(0, 1, length) < p
    return torch.from_numpy(scores), torch.from_numpy(truths)


def _slab(seed, S, R, N):
    rng = np.random.default_rng(seed)
    conf = rng.uniform(0, 1, (S, R, N)).astype(np.float32)
    th0 = np.stack([rng.uniform(0.5, 1.0, R), rng.uniform(0.0, 0.45, R)],
                   axis=1).astype(np.float32)
    mask = rng.uniform(0, 1, (S, R)) < 0.6
    drain = rng.uniform(0.0, 0.3, R).astype(np.float32)
    gains = np.asarray([0.05, 0.2, 0.3, 0.1], np.float32)
    return [torch.from_numpy(a) for a in (conf, th0, mask, drain, gains)]


def _problem(seed, m, k, d):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(m, d)).astype(np.float32)
    trk = rng.normal(size=(k, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    trk /= np.maximum(np.linalg.norm(trk, axis=1, keepdims=True), 1e-12)
    cq = rng.integers(0, 2, m).astype(np.int32)
    tq = rng.integers(0, 2, k).astype(np.int32)
    thr = np.full(m, -0.5, np.float32)
    return [torch.from_numpy(a) for a in (emb, trk, cq, tq, thr)]


def _views(seed, B, H, W, dev, dtype=torch.uint8):
    """Camera views ``batch[:, k]`` of one (B, 3, H, W, 3) batch on
    ``dev``, as ``detect`` passes them (uint8 unless ``dtype`` says)."""
    batch = torch.from_numpy(pixel_batch(seed, B, H, W)).to(dev, dtype)
    return [batch[:, k] for k in range(3)]


def _qkv(seed, B, H, KV, Sq, Sk, hd, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dtype)
            for shape in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd))]


def test_each_launch_counts_once(cuda):
    conf, thr = (t.to(cuda) for t in _fleet(0, 8, 16))
    before = T.LAUNCHES
    T.triage_fleet(conf, thr, capacity=4)
    T.triage_fleet_torch(conf, thr, capacity=4)
    T.empty_launch(cuda)          # the launch floor computes nothing
    assert T.LAUNCHES == before + 1
    s, t = (x.to(cuda) for x in _labels(0, [64, 0], 64))
    before = C.LAUNCHES
    C.calibrate_fleet(s, t, iters=8, min_count=8)
    C.calibrate_fleet_torch(s, t, iters=8, min_count=8)
    assert C.LAUNCHES == before + 1
    slab = [x.to(cuda) for x in _slab(0, 5, 64, 8)]
    before = SS.LAUNCHES
    SS.superstep(*slab, capacity=3)
    SS.superstep_torch(*slab, capacity=3)
    assert SS.LAUNCHES == before + 1
    problem = [x.to(cuda) for x in _problem(1, 16, 16, 32)]
    before = SIM.LAUNCHES
    SIM.associate(*problem)
    SIM.associate_torch(*problem)
    assert SIM.LAUNCHES == before + 1
    q, k, v = (x.to(cuda) for x in _qkv(0, 1, 4, 2, 70, 70, 32))
    before = FA.LAUNCHES
    FA.flash_attention(q, k, v)
    FA.flash_attention_torch(q, k, v)
    assert FA.LAUNCHES == before + 1
    views = _views(0, 2, 40, 50, cuda)
    before = PC.LAUNCHES, MO.LAUNCHES
    mask, _ = PC.pixel_cascade(*views, threshold=40, maxval=255)
    PC.pixel_cascade_torch(*views, threshold=40, maxval=255)
    MO.morph3x3(mask, op="max", fill=0)
    MO.morph3x3_torch(mask, op="max", fill=0)
    assert (PC.LAUNCHES, MO.LAUNCHES) == (before[0] + 1, before[1] + 1)


def test_cuda_tensors_never_fall_back(cuda):
    conf, thr = (t.to(cuda) for t in _fleet(0, 8, 16))
    with pytest.raises(ValueError, match="contiguous"):
        T.triage_fleet(conf.t().contiguous().t(), thr, capacity=4)
    s, t = (x.to(cuda) for x in _labels(0, [10], C.MAX_LANES * 2))
    with pytest.raises(ValueError, match="lanes"):
        C.calibrate_fleet(s, t, iters=8, min_count=8)
    conf, th0, mask, drain, gains = (x.to(cuda) for x in _slab(0, 2, 8, 8))
    with pytest.raises(ValueError, match="empty"):
        SS.superstep(conf[:0], th0, mask[:0], drain, gains, capacity=3)
    emb, _, cq, _, thr = (x.to(cuda) for x in _problem(0, 8, 0, 8))
    trk = torch.zeros((SIM.MAX_TRACKS * 2, 8), device=cuda)
    tq = torch.zeros(len(trk), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="tracks"):
        SIM.associate(emb, trk, cq, tq, thr)
    q, k, v = (x.to(cuda) for x in _qkv(0, 1, 2, 2, 16, 16, 288))
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(q, k, v)
    q, k, v = (x.to(cuda) for x in _qkv(0, 1, 2, 2, 16, 16, 32))
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                           v)
    views = _views(0, 2, 8, 8, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        PC.pixel_cascade(*(v.transpose(1, 2) for v in views), threshold=40,
                         maxval=255)
    with pytest.raises(TypeError, match="uint8 or int32"):
        PC.pixel_cascade(*(v.long() for v in views), threshold=40,
                         maxval=255)
    with pytest.raises(ValueError, match="empty"):
        PC.pixel_cascade(*(v[:0] for v in views), threshold=40, maxval=255)


@pytest.mark.parametrize("rows", TRIAGE_ROWS)
@pytest.mark.parametrize("n", TRIAGE_WIDTHS)
def test_triage_kernel_matches_plain_at_every_width(cuda, n, rows):
    """One to four of a row's lanes a lane (N <= 128) and the chunk walk,
    on and off the buckets, one row to 2^17: routes, slots and counts
    exactly, with NaN lanes, an all-pad row, capacity 0 and overflow."""
    conf, thr = (torch.from_numpy(a).to(cuda)
                 for a in triage_case(rows * 1000 + n, rows, n))
    for capacity in (0, max(1, n // 4), n):
        got = T.triage_fleet(conf, thr, capacity=capacity)
        want = T.triage_fleet_torch(conf, thr, capacity=capacity)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (n, rows, capacity)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_triage_kernel_takes_pointers_its_vectors_cannot(cuda, offset):
    """conf and thresholds ``offset`` floats into a buffer: the float2 /
    float4 loads and the float2 thresholds give way to scalar ones."""
    for n in (16, 64, 128):
        conf, thr = triage_case(offset * n, 9, n)
        views = []
        for a in (conf, thr):
            buf = torch.zeros(offset + a.size, device=cuda)
            buf[offset:] = torch.from_numpy(a).flatten().to(cuda)
            views.append(buf[offset:].view(a.shape))
        for capacity in (0, 5):
            got = T.triage_fleet(*views, capacity=capacity)
            want = T.triage_fleet_torch(*views, capacity=capacity)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (n, offset, capacity)


@pytest.mark.parametrize("n", CALIBRATE_WIDTHS)
def test_calibrate_kernel_matches_plain_on_both_paths(cuda, n):
    """A warp a row up to 256 lanes, a block a row beyond: counts exactly,
    params within CAL_ATOL, degenerate rows exactly the identity."""
    for rows in (4, 64):
        scores, truths = (torch.from_numpy(a).to(cuda)
                          for a in label_case(rows + n, rows, n))
        kp, kc = C.calibrate_fleet(scores, truths, iters=8, min_count=8)
        pp, pc = C.calibrate_fleet_torch(scores, truths, iters=8,
                                         min_count=8)
        assert torch.equal(kc, pc)
        assert float((kp - pp).abs().max()) <= CAL_ATOL
        ident = torch.tensor([1.0, 0.0], device=cuda)
        for r in (1, 2, rows - 1):
            assert torch.equal(kp[r], ident), (n, rows, r)


@pytest.mark.parametrize("name", sorted(ASSOC_CASES))
def test_associate_kernel_matches_plain_on_greedy_cases(cuda, name):
    """The CPU cases of ``tests/test_torch_tracks.py`` on the card: the
    claim loop's shortcuts give the plain version's greedy order."""
    *problem, want = ASSOC_CASES[name]
    ins = [torch.from_numpy(a).to(cuda) for a in problem]
    got, plain = SIM.associate(*ins), SIM.associate_torch(*ins)
    assert got[0].tolist() == plain[0].tolist() == want
    assert float((got[1] - plain[1]).abs().max()) <= 1e-5


@pytest.mark.parametrize("m,k,d", [(128, 128, 32), (1024, 128, 32),
                                   (64, 4096, 32), (40, 300, 72),
                                   (24, 50, 37)])
def test_associate_kernel_matches_plain_across_tiles(cuda, m, k, d):
    """Crop rows over several shared-memory tiles, tracks over several
    staged chunks, D over several column chunks or off the 16-byte
    loads."""
    ins = [x.to(cuda) for x in _problem(m + k + d, m, k, d)]
    ins[4] = torch.linspace(-0.5, 0.9, m, device=cuda)
    got, plain = SIM.associate(*ins), SIM.associate_torch(*ins)
    assert torch.equal(got[0], plain[0])
    assert float((got[1] - plain[1]).abs().max()) <= 1e-5


@pytest.mark.parametrize("S,R,N,capacity,mask_kind", SUPERSTEP_WIDTH_CASES)
def test_superstep_kernel_matches_plain_at_every_row_width(
        cuda, S, R, N, capacity, mask_kind):
    """The CPU cases of ``tests/test_torch_superstep.py`` on the card:
    every packed width and the chunk walk, bit for bit."""
    ins = [torch.from_numpy(a).to(cuda) for a in
           superstep_slab(S * 7 + R * 3 + N, S, R, N, mask_kind)]
    got = SS.superstep(*ins, capacity=capacity)
    want = SS.superstep_torch(*ins, capacity=capacity)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,dtype,causal", [
    (1, 2, 2, 128, 128, 32, torch.float32, True),
    (2, 4, 2, 200, 200, 96, torch.float32, True),
    (1, 8, 2, 64, 256, 16, torch.float32, True),
    (1, 2, 1, 100, 100, 256, torch.float32, False),
    (1, 4, 4, 130, 130, 64, torch.bfloat16, True),
    # the tensor-core kernel: hd 128 GQA, ragged lengths (977: the serving
    # run's prime prompt), Sq != Sk, bf16 at hd 128
    (1, 8, 2, 512, 512, 128, torch.float32, True),
    (1, 4, 4, 1, 1, 64, torch.float32, True),
    (1, 4, 4, 63, 63, 64, torch.float32, True),
    (1, 4, 4, 65, 65, 64, torch.float32, True),
    (1, 4, 4, 977, 977, 64, torch.float32, True),
    (1, 4, 4, 64, 256, 64, torch.float32, False),
    (1, 8, 2, 256, 256, 128, torch.bfloat16, True),
    # the dense family's GQA: chatglm3's 16:1 and command-r's 8:1 at hd
    # 128, off the tile, in f32 and bf16 (int8 weights compute in bf16)
    (1, 32, 2, 300, 300, 128, torch.float32, True),
    (1, 32, 2, 300, 300, 128, torch.bfloat16, True),
    (1, 64, 8, 130, 130, 128, torch.float32, True),
    (1, 64, 8, 130, 130, 128, torch.bfloat16, True),
    # the remaining families' prefills: granite-moe's GQA 2:1, phi3.5-moe's
    # 4:1 at hd 128, hymba's 25 heads over 5, whisper's MHA 20, internvl2's
    # 7:1 behind its image prefix
    (1, 16, 8, 200, 200, 64, torch.float32, True),
    (1, 32, 8, 256, 256, 128, torch.float32, True),
    (1, 25, 5, 256, 256, 64, torch.float32, True),
    (1, 25, 5, 97, 97, 64, torch.bfloat16, True),
    (1, 20, 20, 64, 64, 64, torch.float32, True),
    (1, 14, 2, 264, 264, 64, torch.float32, True),
])
def test_flash_kernel_matches_plain(cuda, B, H, KV, Sq, Sk, hd, dtype,
                                    causal):
    q, k, v = (x.to(cuda) for x in _qkv(1, B, H, KV, Sq, Sk, hd, dtype))
    got = FA.flash_attention(q, k, v, causal=causal)
    want = FA.flash_attention_torch(q, k, v, causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    # the model's (B, S, H, hd) layout goes in as a transposed view
    got_t = FA.flash_attention(*(x.transpose(1, 2).contiguous().transpose(1, 2)
                                 for x in (q, k, v)), causal=causal)
    assert torch.equal(got_t, got)


def test_flash_refuses_unaligned_tensor_core_inputs(cuda):
    """At head dims 64 and 128 K and V come in by TMA: a base or stride
    off the 16-byte grid raises instead of launching."""
    q, k, v = (x.to(cuda) for x in _qkv(2, 1, 2, 2, 16, 16, 64))
    wide = torch.zeros((1, 2, 16, 65), device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention(q, wide[..., 1:], v)
    before = FA.LAUNCHES
    FA.flash_attention(q, k, v)
    assert FA.LAUNCHES == before + 1


def test_serving_counts_flash_launches(cuda):
    """Every cloud prefill launches the kernel once a layer; decode never.
    Tokens equal the host's run on the same weights."""
    cloud_cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                                    attn_impl="flash")
    edge_cfg = get_config("qwen1.5-0.5b").edge_variant()
    cloud = M.init_params(cloud_cfg, torch.Generator().manual_seed(0))
    edge = M.init_params(edge_cfg, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    lengths = (8, 40, 70, 130)

    def serve(device):
        reqs = [Request(rid=i, tokens=rng_tokens[i], max_new=4)
                for i in range(len(lengths))]
        srv = CascadeServer(edge_cfg, edge, cloud_cfg, cloud, slots=2,
                            cache_len=140, device=device,
                            thresholds=ThresholdState(alpha=1.0, beta=0.0))
        return {rid: (r.route, r.output.tolist())
                for rid, r in srv.run(reqs).items()}

    rng_tokens = [rng.integers(0, 512, n).astype(np.int32) for n in lengths]
    FA.LAUNCHES = 0
    got = serve(cuda)
    assert FA.LAUNCHES == cloud_cfg.num_layers * len(lengths)
    assert got == serve("cpu")


def _same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous",
                                                        "views"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32],
                         ids=["uint8", "int32"])
@pytest.mark.parametrize("shape", PIXEL_SHAPES + PIXEL_TILE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_pixel_cascade_kernel_matches_plain(cuda, shape, dtype, strided):
    """Both tiles and both frame types, contiguous frames and the camera
    views ``detect`` passes, at the fixed shapes and on the tiles' edges
    (W * 3 odd among them): the kernel equals the plain version exactly."""
    views = _views(sum(shape), *shape, cuda, dtype)
    if not strided:
        views = [v.contiguous() for v in views]
    for threshold in (0, 40):
        kw = dict(threshold=threshold, maxval=255)
        want = PC.pixel_cascade_torch(*views, **kw)
        _same(PC.pixel_cascade(*views, **kw), want)
        _same(ops.pixel_cascade(*views, threshold=threshold, device=cuda),
              want)


def test_pixel_cascade_counts_over_consecutive_calls(cuda):
    """The count words the kernel leaves zeroed: three calls in a row,
    one with more cameras than any before (a grown workspace), then
    fewer again; a motionless camera counts 0 each time."""
    for i, B in enumerate((3, 3, 3, 10, 2)):
        views = _views(i, B, 96, 128, cuda)
        views[2][0] = views[1][0] = views[0][0]          # camera 0 is still
        mask, counts = PC.pixel_cascade(*views, threshold=40, maxval=255)
        _same((mask, counts), PC.pixel_cascade_torch(*views, threshold=40,
                                                     maxval=255))
        assert counts[0] == 0 and bool((counts[1:] > 0).all())


@pytest.mark.parametrize("maxval", [-7, 0], ids=["negative", "zero"])
def test_pixel_cascade_kernel_takes_any_maxval(cuda, maxval):
    views = _views(3, 2, 40, 70, cuda)
    _same(PC.pixel_cascade(*views, threshold=30, maxval=maxval),
          PC.pixel_cascade_torch(*views, threshold=30, maxval=maxval))


def test_pixel_cascade_is_one_device_operation(cuda):
    """One call on the tick's uint8 views: one kernel, no copy or memset."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    views = _views(1, 12, 96, 128, cuda)
    ops.pixel_cascade(*views, device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ops.pixel_cascade(*views, device=cuda)
        torch.cuda.synchronize()
    assert len([e for e in prof.events()
                if e.device_type == DeviceType.CUDA]) == 1


@pytest.mark.parametrize("op,fill", [("max", 0), ("min", 255)],
                         ids=["dilate", "erode"])
@pytest.mark.parametrize("shape", PIXEL_SHAPES + PIXEL_TILE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_morph3x3_kernel_matches_plain(cuda, shape, op, fill):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.choice([0, 255], size=shape, p=[0.6, 0.4])
                         .astype(np.int32)).to(cuda)
    _same((MO.morph3x3(x, op=op, fill=fill),),
          (MO.morph3x3_torch(x, op=op, fill=fill),))


@pytest.mark.parametrize("op,fill", [("max", 0), ("min", 255)],
                         ids=["dilate", "erode"])
def test_morph3x3_kernel_takes_more_frames_than_grid_z(cuda, op, fill):
    """65,537 frames, past CUDA's grid z limit: blocks loop over cameras."""
    rng = np.random.default_rng(65537)
    x = torch.from_numpy(rng.choice([0, 255], size=(65537, 5, 7))
                         .astype(np.int32)).to(cuda)
    _same((MO.morph3x3(x, op=op, fill=fill),),
          (MO.morph3x3_torch(x, op=op, fill=fill),))


@pytest.mark.parametrize("name,kw", [
    ("city_scale", dict(duration_s=5.0)),
    ("drifting_city", dict(num_cameras=8, duration_s=30.0)),
    ("multi_query_city", dict(num_cameras=8, duration_s=30.0)),
])
def test_run_on_card_counts_every_launch(cuda, name, kw):
    sc = P.SCENARIOS[name](**kw)
    T.LAUNCHES = C.LAUNCHES = 0
    got = P.run_query(sc, device="cuda").summary()
    assert T.LAUNCHES == got["kernel_launches"] > 0
    assert C.LAUNCHES == got["model_updates"]
    assert (got["model_updates"] > 0) == (sc.update_period_s is not None)
    want = P.run_query(sc, device="cpu").summary()
    if sc.update_period_s is None:
        assert got == want          # integer kernel outputs only
    else:
        # float Platt params: the same function, f32 sums in another order
        assert got["model_updates"] == want["model_updates"]
        assert abs(got["accuracy_F2"] - want["accuracy_F2"]) <= 0.05


@pytest.mark.parametrize("name,kw", [
    ("metropolis", dict(num_cameras=1024, duration_s=6.0)),
    ("vehicle_pursuit", dict(duration_s=20.0)),
])
def test_superstep_and_track_runs_on_card(cuda, name, kw):
    sc = P.SCENARIOS[name](**kw)
    SS.LAUNCHES = SIM.LAUNCHES = 0
    rep = P.run_query(sc, device="cuda")
    got = rep.summary()
    assert SS.LAUNCHES == rep.supersteps
    assert SIM.LAUNCHES == rep.track_launches
    assert SS.LAUNCHES + SIM.LAUNCHES > 0
    assert got == P.run_query(sc, device="cpu").summary()


def test_workload_trains_and_scores_on_the_card(cuda):
    """The training slice on the card at tier-1 size: the same integer
    fields as the host's build, ``conf`` within 1e-4 after 10 AdamW steps
    (``tests/test_torch_workload.py``'s tolerance against the reference;
    the fine-tune is chaotic only over many more steps, see
    ``chip_smoke.TRAIN_LOSS_STEPS``), the trained weights on the card, and
    the stream's triage launches counted."""
    from repro_torch.serving.workload import build_workload
    kw = dict(num_cameras=4, num_edges=2, duration_s=40.0, finetune_steps=10,
              seed=3)
    got = build_workload(**kw, device="cuda")
    want = build_workload(**kw, device="cpu")
    assert got.edge_params["embed"].is_cuda
    assert [(i.t_arrival, i.camera, i.edge_device, i.is_query)
            for i in got.items] == [(i.t_arrival, i.camera, i.edge_device,
                                     i.is_query) for i in want.items]
    assert max(abs(a.conf - b.conf)
               for a, b in zip(got.items, want.items)) <= 1e-4
    sc = P.single_edge(duration_s=40.0)
    T.LAUNCHES = 0
    rep = P.run_query(sc, items=got.items, device="cuda").summary()
    assert T.LAUNCHES == rep["kernel_launches"] > 0
    assert rep == P.run_query(sc, items=got.items, device="cpu").summary()


def _serving_pair(arch="qwen1.5-0.5b"):
    cloud_cfg = dataclasses.replace(get_config(arch).reduced(),
                                    attn_impl="flash")
    edge_cfg = get_config(arch).edge_variant()
    return (edge_cfg, M.init_params(edge_cfg, torch.Generator().manual_seed(1)),
            cloud_cfg, M.init_params(cloud_cfg,
                                     torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("self_draft", [False, True], ids=["edge", "self"])
def test_speculative_on_card_matches_host(cuda, self_draft):
    """Speculative decoding on the card: the host's tokens and counts, and
    one flash launch a layer for every cloud prefill (the first, then one a
    round), twice that when the flash cloud drafts for itself."""
    from repro_torch.core import speculative as SP
    edge_cfg, edge, cloud_cfg, cloud = _serving_pair()
    # scaled, the trunk picks the greedy token (at the init scale it is the
    # input token and every draft is accepted)
    cloud = {**cloud, "layers": {
        block: {name: 3.0 * t if t.ndim >= 3 and not name.startswith("b")
                else t for name, t in leaves.items()}
        for block, leaves in cloud["layers"].items()}}
    if self_draft:
        edge_cfg, edge = cloud_cfg, cloud
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cloud_cfg.vocab_size, (1, 70)))

    def run(dev):
        on = M.tree_map(lambda t: t.to(dev), edge), M.tree_map(
            lambda t: t.to(dev), cloud)
        return SP.speculative_generate(edge_cfg, on[0], cloud_cfg, on[1],
                                       prompt.to(dev), steps=12, k=4)

    FA.LAUNCHES = 0
    got, stats = run(cuda)
    launches = FA.LAUNCHES
    want, want_stats = run("cpu")
    assert torch.equal(got.cpu(), want)
    assert stats == want_stats
    per_prefill = cloud_cfg.num_layers * (2 if self_draft else 1)
    assert launches == per_prefill * (1 + stats.cloud_steps)
    if self_draft:
        assert stats.acceptance_rate == 1.0


@pytest.mark.parametrize("mode", ["int8_kv", "int8_weights"])
def test_int8_serving_on_card_matches_host(cuda, mode):
    """``DecodeEngine`` on an int8-KV and an int8-weight model: the host's
    tokens; int8 weights compute in bf16, so each prefill's flash launches
    take the bf16 kernel."""
    from repro_torch.distributed import quantize as QZ
    from repro_torch.serving.engine import DecodeEngine
    _, _, cfg, params = _serving_pair("qwen3-8b")
    if mode == "int8_kv":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    else:
        params = QZ.quantize_tree(M.tree_map(
            lambda t: t.to(torch.bfloat16), params), cfg)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 70, 130)]
    seen = []
    kernel = FA.flash_attention

    def spy(q, k, v, **kw):
        seen.append(q.dtype)
        return kernel(q, k, v, **kw)

    def serve(dev):
        eng = DecodeEngine(cfg, params, slots=3, cache_len=140, device=dev)
        for i, p in enumerate(prompts):
            assert eng.admit(Request(rid=i, tokens=p, max_new=6))
        outs = {}
        while eng.active:
            for rid, gen in eng.step():
                outs[rid] = gen
        return outs

    FA.flash_attention = spy
    try:
        got = serve(cuda)
    finally:
        FA.flash_attention = kernel
    assert got == serve("cpu")
    want_dtype = torch.bfloat16 if mode == "int8_weights" else torch.float32
    assert seen == [want_dtype] * (cfg.num_layers * len(prompts))


#: the remaining families' reduced configs on the card against the host:
#: f32 products in another order and flash's split TF32 (within 2e-5 of
#: its plain version) keep the logits this close
FAMILY_LOGIT_ATOL = 1e-4


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
                                  "hymba-1.5b", "whisper-large-v3",
                                  "internvl2-1b"])
def test_family_prefill_and_decode_on_card_match_host(cuda, arch):
    """Each family's reduced config under flash: forward, prefill and
    three decode steps on the card within ``FAMILY_LOGIT_ATOL`` of the
    host's, and one flash launch a layer for each attention prefill."""
    from repro_torch.models import transformer as TR
    cfg = dataclasses.replace(get_config(arch).reduced(), attn_impl="flash")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 35), generator=g)
    kw = {}
    if cfg.is_encdec:
        kw["audio_frames"] = torch.randn((2, cfg.enc_seq, cfg.d_model),
                                         generator=g)
    if cfg.num_img_tokens:
        kw["img_embeds"] = torch.randn((2, cfg.num_img_tokens, 1024),
                                       generator=g)

    def run(dev):
        p = M.tree_map(lambda t: t.to(dev), params)
        k = {n: t.to(dev) for n, t in kw.items()}
        t = toks.to(dev)
        h, aux = TR.forward(cfg, p, t[:, :32], **k)
        out = [TR.lm_logits(cfg, p, h).cpu(), aux.cpu()[None]]
        logits, cache = TR.prefill(cfg, p, t[:, :32], cache_len=40, **k)
        out.append(logits.cpu())
        for i in range(32, 35):
            logits, cache = TR.decode_step(cfg, p, cache, t[:, i])
            out.append(logits.cpu())
        return out

    FA.LAUNCHES = 0
    got = run(cuda)
    assert FA.LAUNCHES == (2 * cfg.num_layers if cfg.has_attn else 0)
    for a, b in zip(got, run("cpu")):
        torch.testing.assert_close(a, b, atol=FAMILY_LOGIT_ATOL, rtol=0)


def test_family_draws_on_the_card(cuda):
    """``init_params`` draws on its generator's device."""
    cfg = get_config("mamba2-2.7b").reduced()
    params = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    assert all(t.device.type == "cuda" for _, t in M.leaves(params))
    assert float(params["layers"]["ssm"]["a_log"].min()) >= 0.0


#: the LLM train step on the card against the host: f32 on both, sums in
#: another order (``chip_smoke.LLM_LOSS_ATOL``/``LLM_GNORM_RTOL``); a
#: MoE's router near-tie may send a token to another expert
#: (``chip_smoke.LLM_MOE_LOSS_ATOL``)
TRAIN_LOSS_ATOL = 1e-4
TRAIN_GNORM_RTOL = 1e-4
TRAIN_MOE_LOSS_ATOL = 1e-2


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_step_on_card_matches_host(cuda, arch):
    """One launcher step of each reduced config, from the same weights
    and batch: loss (and grad_norm, but for the MoEs) within the bounds
    above, every metric on the card, the parameters moved."""
    from repro_torch.launch import train as LT
    from repro_torch.optim import adamw as A
    from repro_torch.train import steps as ST
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    batch = next(LT.batches(cfg, 2, 32, "cpu"))
    step = LT.make_step(cfg, lr=1e-3, steps=10)

    def run(dev):
        p = M.tree_map(lambda t: t.to(dev), params)
        state = ST.TrainState(p, A.init(p), torch.zeros(
            (), dtype=torch.int32, device=dev))
        return step(state, {k: v.to(dev) for k, v in batch.items()})

    new, got = run(cuda)
    _, want = run("cpu")
    assert all(v.device.type == "cuda" for v in got.values())
    atol = TRAIN_MOE_LOSS_ATOL if cfg.is_moe else TRAIN_LOSS_ATOL
    assert abs(float(got["loss"]) - float(want["loss"])) <= atol
    if not cfg.is_moe:
        gn = float(want["grad_norm"])
        assert abs(float(got["grad_norm"]) - gn) <= TRAIN_GNORM_RTOL * gn
    assert int(new.step) == 1
    assert max(float((a.cpu() - b).abs().max()) for (_, a), (_, b) in
               zip(M.leaves(new.params), M.leaves(params))) > 0


def test_flash_refuses_a_gradient_on_the_card(cuda):
    """The kernel writes its output through a raw pointer, so it refuses
    a forward that autograd would differentiate, before any launch;
    under ``no_grad`` it launches as before."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((1, 4, 64, 64), generator=g, device=cuda)
               for _ in range(3))
    FA.LAUNCHES = 0
    with pytest.raises(RuntimeError, match="no backward"):
        FA.flash_attention(q.requires_grad_(), k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v, device=cuda)
    assert FA.LAUNCHES == 0
    with torch.no_grad():
        out = FA.flash_attention(q, k, v)
    assert FA.LAUNCHES == 1 and not out.requires_grad


# --- the multi-device slice on the card ---------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_superstep_is_bit_identical_on_card(cuda, n):
    """``_superstep_fn`` over ``n`` row shards on cuda:0: ``n`` kernel
    launches, outputs bit-identical to one launch."""
    from repro_torch.system.superstep import _superstep_fn
    args = [torch.from_numpy(a).to(cuda)
            for a in superstep_slab(n, 16, 256, 8)]
    want = _superstep_fn(4, 1)(*args)
    SS.LAUNCHES = 0
    got = _superstep_fn(4, n)(*args)
    assert SS.LAUNCHES == n
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g, w)


def test_metropolis_fleet_in_shards_on_card(cuda):
    kw = dict(num_cameras=1024, duration_s=6.0)
    solo = P.run_query(P.metropolis(shard_fleet=False, **kw), device="cuda")
    SS.LAUNCHES = 0
    split = P.run_query(P.metropolis(shard_fleet=4, **kw), device="cuda")
    assert SS.LAUNCHES == 4 * split.supersteps > 0
    keys = ("kernel_launches", "launches_per_tick")
    assert {k: v for k, v in split.summary().items() if k not in keys} == \
        {k: v for k, v in solo.summary().items() if k not in keys}
    assert split.thresholds == solo.thresholds


def test_one_card_mesh_step_equals_plain(cuda):
    """Reduced qwen1.5-0.5b on a (1, 1) mesh over a one-rank NCCL group:
    one train step bit for bit the plain step's; a prefill under the
    serve rules with flash on the local heads equals the plain one."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import multihost
    from repro_torch.launch import train as LT
    from repro_torch.train import steps as ST
    cfg = get_config("qwen1.5-0.5b").reduced()
    multihost.initialize(f"localhost:{LT.free_port()}", 1, 0, device="cuda")
    try:
        mesh = MESH.make_host_mesh("cuda")
        runs = []
        for m in (None, mesh):
            state = LT.init_state(cfg, cuda, m)
            step = LT.make_step(cfg, lr=1e-3, steps=10,
                                ctx=SH.ActCtx(cfg, m) if m else None)
            _, metrics = step(state, next(LT.batches(cfg, 2, 64, cuda, m)))
            runs.append((float(metrics["loss"]),
                         float(metrics["grad_norm"])))
        assert runs[0] == runs[1]
        fcfg = dataclasses.replace(cfg, attn_impl="flash")
        params = M.init_params(fcfg, torch.Generator(device=cuda)
                               .manual_seed(0))
        toks = torch.randint(0, cfg.vocab_size, (1, 128), device=cuda,
                             dtype=torch.int32)
        plain, _ = ST.make_prefill_step(fcfg)(params, {"tokens": toks})
        FA.LAUNCHES = 0
        dp = SH.distribute_tree(params, SH.param_shardings(fcfg, mesh,
                                                           "serve"))
        meshed, _ = ST.make_prefill_step(fcfg, ctx=SH.ActCtx(fcfg, mesh))(
            dp, {"tokens": SH.distribute(toks, SH.NamedSharding(
                mesh, ("data", None)))})
        assert FA.LAUNCHES == cfg.num_layers
        torch.testing.assert_close(meshed.full_tensor(), plain, rtol=0,
                                   atol=1e-5)
    finally:
        dist.destroy_process_group()
