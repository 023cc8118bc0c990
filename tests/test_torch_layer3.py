"""The segment program: mp3tpu_torch.models.layer3 against
mp3tpu.models.layer3 on the CPU.

Constants loaded from the JAX package must equal the module's own.  On
one small stereo segment with transients, block types and the carried
automaton state must match exactly; the side-info rows (part2_3_length,
gains, tables, regions, ...) must be identical on at least 90% of the
granules -- float32 round-off in two libraries can flip one quantized
line and move a granule's search (see tests/test_torch_loop.py).
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp3tpu.config import EncoderConfig
from mp3tpu.models import layer3 as jlayer3
from mp3tpu.ops import jaxbits, jaxdsp, jaxloop, jaxpsy
from mp3tpu.runtime.wav import read_wav
from mp3tpu.tables import mpeg
from mp3tpu_torch.models.layer3 import Layer3SegmentEncoder
from test_torch_lsf_standard import jax_standard_24k  # noqa: F401

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)

S = 16


def _jax_constants(version, sf):
    hz = float(mpeg.S_FREQ_KHZ[version][sf]) * 1000.0
    return dict(
        static=jaxloop._static(version, sf),
        psy_mats=jaxpsy._psy_mats(hz),
        dft={n: jaxpsy._dft_mats(n) for n in (1024, 256)},
        hann={n: jaxpsy._hann(n) for n in (1024, 256)},
        dsp=dict(enwindow_rev=jaxdsp._ENWINDOW_REV,
                 ana_filter_rev=jaxdsp._ANA_FILTER_REV,
                 basis_long=jaxdsp._BASIS_LONG,
                 basis_short=jaxdsp._BASIS_SHORT, alias=jaxdsp._ALIAS))


@pytest.mark.parametrize("version,sf", [
    (mpeg.MPEG1, 0), (mpeg.MPEG1, 1), (mpeg.MPEG1, 2),
    (mpeg.MPEG2_LSF, 0), (mpeg.MPEG2_LSF, 1), (mpeg.MPEG2_LSF, 2)],
    ids=["0", "1", "2", "lsf0", "lsf1", "lsf2"])
def test_constants_from_jax_equal_own_buffers(version, sf,
                                              jax_standard_24k):
    own = Layer3SegmentEncoder(version, sf, "cpu")
    loaded = Layer3SegmentEncoder(version, sf, "cpu") \
        .load_numpy_constants(_jax_constants(version, sf))
    a, b = dict(own.named_buffers()), dict(loaded.named_buffers())
    assert a.keys() == b.keys() and len(a) > 40
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k
    for group in ("st", "psy", "dsp", "bits"):
        ta, tb = own.tables(group), loaded.tables(group)
        for k in ta:
            if not isinstance(ta[k], torch.Tensor):
                assert ta[k] == tb[k], (group, k)


def _segment(golden_dir, pos):
    """A 16-granule stereo segment of trans_st_128 at granule pos, with
    its 4 preceding blocks, as the encoder slices it."""
    pcm, rate = read_wav(os.path.join(golden_dir, "trans_st_128.wav"))
    x = pcm.T.astype(np.int16)
    G = -(-x.shape[1] // 1152) * 2
    x = np.pad(x, ((0, 0), (0, G * 576 - x.shape[1]))).reshape(2, G, 576)
    bl = np.zeros((2, 4 + S, 576), np.int16)
    bl[:, :4] = x[:, pos - 4:pos]
    bl[:, 4:] = x[:, pos:pos + S]
    return bl


@pytest.fixture(scope="module")
def segment_args():
    """The scalar arguments of one 128 kbps stereo segment of S granules,
    of which the last frame is bucket padding."""
    cfg = EncoderConfig(layer=3, mode=mpeg.MODE_STEREO, bitrate_kbps=128,
                        sample_rate_hz=44100).finalize()
    nch, mode_gr = 2, 2
    bits_per_frame = 8 * cfg.slots_per_frame()[0]
    sideinfo = mpeg.sideinfo_bits(cfg.version, nch)
    mean_bits = (bits_per_frame - sideinfo) // mode_gr
    resv_max = min(max(0, 7680 - bits_per_frame), 4088)
    cap = jaxbits.payload_cap_words(S // mode_gr, bits_per_frame, sideinfo,
                                    resv_max, nch * S)
    return cfg, dict(payload_words=96, nch=nch, flat_cap=cap, n_real=S - 2,
                     mean_bits=mean_bits, resv_max=resv_max,
                     mode_gr=mode_gr, delta=28)


def _run_both(cfg, a, bl, fsm0, size0):
    ref = jlayer3.encode_segment_fused(
        jnp.asarray(bl), jnp.asarray(fsm0), jnp.int32(size0), cfg.version,
        cfg.sampling_frequency, 44100.0, a["payload_words"], a["nch"],
        a["flat_cap"], a["n_real"], a["mean_bits"], a["resv_max"],
        a["mode_gr"], a["delta"])
    enc = Layer3SegmentEncoder(cfg.version, cfg.sampling_frequency, "cpu")
    got = enc(torch.tensor(bl), fsm0, size0, a["payload_words"], a["nch"],
              a["flat_cap"], a["n_real"], a["mean_bits"], a["resv_max"],
              a["mode_gr"], a["delta"])
    return ref, got


def _assert_segment_matches(ref, got, nch, cap, cols=slice(None)):
    bt_ref = np.asarray(ref["block_type"])
    np.testing.assert_array_equal(bt_ref, got["block_type"].numpy())
    np.testing.assert_array_equal(np.asarray(ref["fsm_state"]),
                                  got["fsm_state"].numpy())
    side_ref = np.asarray(ref["side"], np.int64)
    side = got["side"].numpy().astype(np.int64)
    assert side.shape == side_ref.shape == (nch * S, 19)
    assert got["side"].dtype == torch.int16
    # window_switching_flag and block_type columns
    np.testing.assert_array_equal(side_ref[:, 4:6], side[:, 4:6])
    same = (side_ref[:, cols] == side[:, cols]).all(axis=1)
    for g in np.where(~same)[0]:
        print(f"granule {g}: columns",
              np.where(side_ref[g] != side[g])[0].tolist(),
              "jax", side_ref[g].tolist(), "torch", side[g].tolist())
    assert same.mean() >= 0.9, same.mean()
    # the compacted payload carries exactly the side table's words
    words = int(((side[:, 0] + 31) >> 5).sum())
    assert got["payload"].shape == (cap,)
    assert (got["payload"][words:] == 0).all()
    return bt_ref


@pytest.fixture(scope="module")
def first_segment(golden_dir, segment_args):
    cfg, a = segment_args
    return _run_both(cfg, a, _segment(golden_dir, 36),
                     np.array([0, 2], np.int32), 800)


def test_segment_matches_jax(segment_args, first_segment):
    cfg, a = segment_args
    ref, got = first_segment
    bt_ref = _assert_segment_matches(ref, got, a["nch"], a["flat_cap"])
    assert (bt_ref == 2).any(), "segment lost its short blocks"


def test_segment_continues_from_jax_carry(golden_dir, segment_args,
                                          first_segment):
    """The next segment, on both sides, starts from the carry that the
    JAX segment returned, passed to the port as numpy values."""
    cfg, a = segment_args
    ref, _ = first_segment
    fsm, size = np.array(ref["fsm_state"]), np.array(ref["size"])
    ref2, got2 = _run_both(cfg, a, _segment(golden_dir, 36 + S), fsm, size)
    # part2_3_length is held to the segment's total: here 4 of the 32
    # granules differ from JAX by one flipped quantized line, a few bits
    # each, and in nothing else
    _assert_segment_matches(ref2, got2, a["nch"], a["flat_cap"],
                            cols=slice(1, None))
    p23_ref = np.asarray(ref2["side"], np.int64)[:, 0].sum()
    p23 = got2["side"].numpy().astype(np.int64)[:, 0].sum()
    assert abs(p23 - p23_ref) <= 0.01 * p23_ref, (p23, p23_ref)
