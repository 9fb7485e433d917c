"""Padding-bucket table for the fleet kernels — importable without torch.

Every fleet-shaped kernel launch in the repo pads its axes up to
power-of-two buckets so a run's stream of varying tick matrices hits a
handful of cached compilations (see ``kernels/ops.py``).  The bucket
arithmetic lives here, framework-free, so config-layer code — notably
``Scenario.__post_init__`` — can validate fleet dimensions against the
same table the kernels will actually pad to and raise a clear
``ValueError`` *before* an oversized (Q·E, N) launch surfaces as an
opaque kernel shape error deep inside a run.

The limits are the reference package's, kept identical so a scenario
that validates in one package validates in the other: the fused triage
launch takes the whole padded fleet at once.  ``MAX_FLEET_ROWS`` bounds
the per-tick folded (Q·E) row space a scenario may declare;
``MAX_SUPERSTEP_ELEMS`` bounds one scan superstep's folded (S·R, N) slab
(the superstep planner clamps its tick span to stay under it, never
errors).
"""
from __future__ import annotations

#: minimum padded size of the edge / camera-lane axes (see ``bucket``)
BUCKET_MIN = 8

#: largest padded Q·E row count a scenario may fold into one fleet launch
MAX_FLEET_ROWS = 1 << 17

#: largest padded element count (S·R·N) of one scan-superstep triage slab
MAX_SUPERSTEP_ELEMS = 1 << 22

# --- pixel-cascade frame tiles ------------------------------------------------
# The fused pixel-cascade kernel (``kernels/pixel_cascade.py``) walks each
# camera's frame in (FRAME_BAND_H, W) row bands with the W axis padded to
# lane multiples; the staged morphology kernels use the same band height.
# These are the numbers ``validate_frame_hw`` checks a Scenario.frame_hw
# against, so a bad frame size raises here — with the padded tile spelled
# out — instead of as a kernel shape error at first render.

#: output rows per pixel-cascade band (the stencil pipeline's block height)
FRAME_BAND_H = 32

#: lane-aligned width multiple every frame pads up to before a launch
FRAME_LANE_W = 128

#: smallest frame side the cascade's 3x3 stencil halos make sense for
MIN_FRAME_SIDE = 16

#: largest padded per-camera pixel count (H_pad * W_pad) of one frame —
#: bounds one frame slab like ``MAX_FLEET_ROWS`` bounds triage
MAX_FRAME_ELEMS = 1 << 22


def frame_pad(h: int, w: int):
    """Padded (H, W) the pixel kernels actually launch for a (h, w) frame."""
    hp = -(-h // FRAME_BAND_H) * FRAME_BAND_H
    wp = -(-w // FRAME_LANE_W) * FRAME_LANE_W
    return hp, wp


def validate_frame_hw(name: str, h: int, w: int) -> None:
    """Reject frame sizes the pixel-cascade tile table cannot host.

    Raises ``ValueError`` with the padded tile sizes spelled out — the
    same numbers that would otherwise appear (unexplained) in a kernel
    block-shape error at the first rendered tick."""
    if h < MIN_FRAME_SIDE or w < MIN_FRAME_SIDE:
        raise ValueError(
            f"scenario {name!r}: frame_hw=({h}, {w}) is below the pixel "
            f"cascade's minimum frame side of {MIN_FRAME_SIDE} px — the "
            f"fused 3x3 stencil pipeline needs at least one "
            f"{MIN_FRAME_SIDE}x{MIN_FRAME_SIDE} sprite's worth of pixels "
            f"per frame")
    hp, wp = frame_pad(h, w)
    if hp * wp > MAX_FRAME_ELEMS:
        raise ValueError(
            f"scenario {name!r}: frame_hw=({h}, {w}) pads to "
            f"({hp}, {wp}) = {hp * wp} pixels per camera frame, over the "
            f"pixel-cascade tile table's limit of {MAX_FRAME_ELEMS} — "
            f"this would surface as an opaque kernel shape error at the "
            f"first rendered tick; shrink the frame")


def bucket(n: int, minimum: int = BUCKET_MIN) -> int:
    """Next power-of-two size >= n (jit-cache-stable padding bucket)."""
    return max(minimum, 1 << (max(n - 1, 1)).bit_length())


def bucket_q(q: int) -> int:
    """Power-of-two bucket for the query axis, minimum 1.

    The query axis stays tiny (a handful of live CQs), so unlike the edge
    and camera axes it gets no minimum-8 floor: a single-query run pays
    zero padding and folds to exactly the (E, N) layout it had before the
    query axis existed."""
    return 1 if q <= 1 else 1 << (q - 1).bit_length()


def fleet_rows(num_queries: int, num_edges: int) -> int:
    """Padded row count of the folded (Q·E, N) fleet-triage launch."""
    return bucket_q(num_queries) * bucket(num_edges)


def validate_fleet_dims(name: str, num_queries: int, num_edges: int,
                        capacity: int) -> None:
    """Reject fleet dimensions the kernel bucket table cannot host.

    Raises ``ValueError`` with the padded sizes spelled out — the same
    numbers that would otherwise appear (unexplained) in a kernel
    block-shape error at first launch."""
    if num_edges < 1:
        raise ValueError(
            f"scenario {name!r}: needs at least one edge "
            f"(edge_speeds is empty) — the fused (Q, E, N) triage launch "
            f"has no rows without an edge axis")
    if capacity < 1:
        raise ValueError(
            f"scenario {name!r}: escalation_capacity={capacity} must be "
            f">= 1 (it sizes the kernel's per-row escalation buffer)")
    rows = fleet_rows(num_queries, num_edges)
    if rows > MAX_FLEET_ROWS:
        raise ValueError(
            f"scenario {name!r}: {num_queries} queries x {num_edges} edges "
            f"pads to {bucket_q(num_queries)} x {bucket(num_edges)} = "
            f"{rows} fleet rows, over the kernel bucket table's limit of "
            f"{MAX_FLEET_ROWS} — this would surface as an opaque kernel "
            f"block-shape error at the first fused triage launch; shrink "
            f"the fleet or split the query set")
