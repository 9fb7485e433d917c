"""The port's int8 wire codec and downlink accounting vs the reference.

The codec is a numpy copy, so it must agree with the reference's bit for
bit; ``Transport.ship_update`` must charge the same quantized bytes and
deliver the same round-tripped Platt pair.  (The end-to-end quantized
and speculative rows are held against the reference in
``tests/test_torch_feedback.py``.)
"""
import dataclasses

import numpy as np
import pytest

from repro.distributed import quantize as RQ
from repro_torch.distributed import quantize as QZ
from repro_torch.system import single_edge
from repro_torch.system.transport import Transport


@pytest.mark.parametrize("shape", [(2,), (7,), (4, 33), (3, 8, 8), (1, 1)])
def test_wire_codec_identical_to_reference(shape):
    rng = np.random.default_rng(len(shape) * 10 + shape[0])
    x = (rng.normal(size=shape) * rng.uniform(0.1, 40)).astype(np.float32)
    got, want = QZ.encode_wire(x), RQ.encode_wire(x)
    for f in ("q", "scale", "zero"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.nbytes == want.nbytes
    np.testing.assert_array_equal(QZ.decode_wire(got), RQ.decode_wire(want))
    err = np.abs(QZ.decode_wire(got).reshape(got.scale.size, -1)
                 - x.reshape(got.scale.size, -1))
    assert np.all(err <= got.scale[:, None] / 2 + 1e-7)


@pytest.mark.parametrize("fp_nbytes", [0, 8, 4096, 64 * 1024, 4 << 20])
def test_wire_nbytes_identical_to_reference(fp_nbytes):
    assert QZ.quantized_wire_nbytes(fp_nbytes) == \
        RQ.quantized_wire_nbytes(fp_nbytes)


def test_wire_rejects_negative_sizes_and_keeps_constants_exact():
    with pytest.raises(ValueError):
        QZ.quantized_wire_nbytes(-1)
    x = np.full((3, 17), 0.731, np.float32)
    x[1] = -2.5
    np.testing.assert_array_equal(QZ.decode_wire(QZ.encode_wire(x)), x)


def test_ship_update_charges_and_delivers_like_the_reference():
    sc = single_edge(num_cameras=2, duration_s=1.0)
    tq = Transport(dataclasses.replace(sc, quantize_downlink=True))
    tf = Transport(dataclasses.replace(sc, quantize_downlink=False))
    vals = np.asarray([1.73, -0.42], np.float32)
    _, got_q = tq.ship_update(0.0, 64 * 1024, values=vals)
    _, got_f = tf.ship_update(0.0, 64 * 1024, values=vals)
    assert tq.downloaded_bytes == RQ.quantized_wire_nbytes(64 * 1024)
    assert tq.downlink_fp_bytes == tf.downloaded_bytes == 64 * 1024
    assert got_f is vals
    np.testing.assert_array_equal(
        got_q, RQ.decode_wire(RQ.encode_wire(vals)))
