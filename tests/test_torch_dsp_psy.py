"""Filterbank, MDCT and psy model 2: mp3tpu_torch against the JAX
package on golden-WAV blocks, on the CPU.

Float outputs are held to float32 round-off (sums run in another order
in the two libraries): xr within 1e-5 of max|xr|; pe and the ratios
within 1e-4 relative on noise-like content, and on tonal and transient
content (where float32 DFT round-off dominates quiet bands) no further
from a float64 evaluation than the JAX package's own float32 result,
within a factor 4 in RMS.  block_type and the carried automaton state are
threshold decisions on pe >= 1800 and must match exactly, so the test
first asserts that no granule's pe lies within 0.5% of 1800.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp3tpu.ops import jaxdsp, jaxpsy
from mp3tpu.runtime.wav import read_wav
from mp3tpu_torch.ops import dsp, psy

# the CPU path is thousands of small ops: intra-op threads only contend
# with the other test processes
torch.set_num_threads(1)

S = 64  # granules per chunk


def test_constants_equal_jax():
    c = dsp.numpy_constants()
    np.testing.assert_array_equal(c["enwindow_rev"], jaxdsp._ENWINDOW_REV)
    np.testing.assert_array_equal(c["ana_filter_rev"],
                                  jaxdsp._ANA_FILTER_REV)
    np.testing.assert_array_equal(c["alias"], jaxdsp._ALIAS)
    np.testing.assert_array_equal(c["basis_short"], jaxdsp._BASIS_SHORT)
    for b in (0, 1, 3):
        np.testing.assert_array_equal(c["basis_long"][b],
                                      jaxdsp._BASIS_LONG[b])
    for hz in (44100.0, 48000.0, 32000.0, 22050.0, 24000.0, 16000.0):
        ref, got = jaxpsy._psy_mats(hz), psy.psy_mats(hz)
        for k in ref:
            if k == "P":
                for pk in ref["P"]:
                    np.testing.assert_array_equal(
                        np.asarray(ref["P"][pk]), np.asarray(got["P"][pk]))
            else:
                np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
    for n in (1024, 256):
        np.testing.assert_array_equal(jaxpsy._dft_mats(n)[0],
                                      psy.dft_mats(n)[0])
        np.testing.assert_array_equal(jaxpsy._dft_mats(n)[1],
                                      psy.dft_mats(n)[1])
        np.testing.assert_array_equal(jaxpsy._hann(n), psy.hann(n))


def test_fsm_prefix_equals_serial_automaton():
    rng = np.random.RandomState(3)
    PT = psy.device_tables(psy.numpy_constants(44100.0), "cpu")
    for G in (1, 2, 5, 64, 77):
        attack = rng.rand(G) < 0.3
        for init in (0, 2, 3):
            emit, final = psy._fsm_blocktype(torch.tensor(attack),
                                             torch.tensor(init), PT)
            state, want = init, []
            for a in attack:
                want.append((1 if state == 0 else 2) if a else state)
                state = 2 if a else (3 if state == 2 else 0)
            assert emit.tolist() == want
            assert int(final) == state


def _chunk(golden_dir, name, ch, pos):
    """blocks_ext (2 warmup + S, 576) and halo2 (2, 576) at granule pos,
    as encode_segment_fused slices them."""
    pcm, rate = read_wav(os.path.join(golden_dir, f"{name}.wav"))
    x = pcm[:, ch].astype(np.float32)
    G = -(-len(x) // 576)
    x = np.pad(x, (0, G * 576 - len(x))).reshape(G, 576)
    ext = np.zeros((4 + S, 576), np.float32)
    lo = max(pos - 4, 0)
    ext[4 - (pos - lo):4] = x[lo:pos]
    n = min(S, G - pos)
    ext[4:4 + n] = x[pos:pos + n]
    return ext[2:], ext[:2], float(rate)


# noise-like content: every band's energy is far above the float32 DFT
# round-off, so the two float32 implementations agree to 1e-4
STRICT = [("q_mix_st_128", 0, 0, 0), ("q_mix_st_320_48k", 1, 32, 2),
          ("q_noise_st_128", 1, 0, 0), ("q_mix_mono_96_32k", 0, 16, 3)]
# transients, tones and sweeps: block switching and the automaton carry
# must match exactly; their quiet bands sit at the float32 round-off of
# the DFT, where the JAX package itself strays from its own float64
# evaluation by up to a few percent (pe near 1e-3), so the port is held
# to the reference's own float32 error instead: its RMS relative error
# against the float64 evaluation is at most 4x the JAX package's (the
# largest ratio over the golden fixtures' first chunks is 3.3)
CONDITIONED = [("trans_st_128", 0, 0, 0), ("trans_st_128", 1, 64, 2),
               ("sine_st_128_32k", 1, 20, 0), ("sweep_st_320_48k", 0, 30, 3)]


def _analyze_jax(blocks_ext, halo2, rate, fsm_init, dtype=jnp.float32):
    """The JAX package's chunk analysis (models/layer3._analyze_chunk_body)."""
    bj = jnp.asarray(blocks_ext, dtype)
    psy_out = jaxpsy.psycho_granules(bj, jnp.asarray(halo2, dtype), rate,
                                     dtype=dtype, warmup=2,
                                     fsm_init=jnp.int32(fsm_init))
    sc = bj / 32768.0
    sb = jaxdsp.subband_granules(sc[2:], sc[1, 64:])
    sb_prev = jaxdsp.subband_granules(sc[1][None], sc[0, 64:])[0]
    xr = jaxdsp.mdct_granules(sb, sb_prev, psy_out["block_type"])
    return psy_out, np.asarray(xr)


def _analyze_torch(blocks_ext, halo2, rate, fsm_init):
    PT = psy.device_tables(psy.numpy_constants(rate), "cpu")
    DT = dsp.device_tables(dsp.numpy_constants(), "cpu")
    b = torch.tensor(blocks_ext)
    out = psy.psycho_granules(b, torch.tensor(halo2), PT, warmup=2,
                              fsm_init=torch.tensor(fsm_init))
    st = b / 32768.0
    sb = dsp.subband_granules(st[2:], st[1, 64:], DT)
    sb_prev = dsp.subband_granules(st[1][None], st[0, 64:], DT)[0]
    xr = dsp.mdct_granules(sb, sb_prev, out["block_type"], DT).numpy()
    return out, xr


def _rms_rel(a, b):
    """Root-mean-square relative error of a against b."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(np.mean((np.abs(a - b) / np.maximum(np.abs(b), 1e-30))
                           ** 2))


@pytest.mark.parametrize(
    "name,ch,pos,fsm_init,strict",
    [c + (True,) for c in STRICT] + [c + (False,) for c in CONDITIONED],
    ids=[f"{c[0]}-ch{c[1]}-g{c[2]}" for c in STRICT + CONDITIONED])
def test_analysis_matches_jax(golden_dir, name, ch, pos, fsm_init, strict):
    blocks_ext, halo2, rate = _chunk(golden_dir, name, ch, pos)
    ref, ref_xr = _analyze_jax(blocks_ext, halo2, rate, fsm_init)
    got, xr = _analyze_torch(blocks_ext, halo2, rate, fsm_init)

    pe_ref = np.asarray(ref["pe"], np.float64)
    assert np.all(np.abs(pe_ref - 1800.0) > 0.005 * 1800.0), \
        "a granule sits on the block-switch knife edge"
    np.testing.assert_array_equal(np.asarray(ref["block_type"]),
                                  got["block_type"].numpy())
    assert int(ref["fsm_state"]) == int(got["fsm_state"])
    if name.startswith("trans"):
        assert (np.asarray(ref["block_type"]) == 2).any(), \
            "fixture lost its short blocks"
    assert np.abs(xr - ref_xr).max() <= 1e-5 * np.abs(ref_xr).max()

    keys = ("pe", "ratio_l", "ratio_s")
    if strict:
        for k in keys:
            np.testing.assert_allclose(got[k].numpy(),
                                       np.asarray(ref[k], np.float64),
                                       rtol=1e-4, atol=0, err_msg=k)
    else:
        ref64, _ = _analyze_jax(blocks_ext, halo2, rate, fsm_init,
                                dtype=jnp.float64)
        for k in keys:
            own = _rms_rel(ref[k], ref64[k])
            port = _rms_rel(got[k].numpy(), ref64[k])
            assert port <= 4.0 * own + 1e-6, (k, port, own)
