"""K5's design (``csrc/alloc12.cu``) as a lane-level model
(``model_frame`` of tests/test_torch_layer12_card.py: each frame a warp,
lane i holding the candidates 2i and 2i + 1, the argmin as five
xor-shuffle rounds over (value, index) pairs, the winner lane's update
and broadcast), held to the plain version K5 replaces -- the JAX
package's host code, ``runtime/alloc12.joint_mode`` and
``greedy_allocation``, all frames in lockstep -- and to the sequential
oracles of ``numpy_ref/layer12`` (``_a_bit_allocation_II`` / ``_I`` with
the joint decision of its ``encode``) on every output.

Cases: the SMR and scfsi of the six Layer I/II fixtures from the JAX
package's ``analyze_frames`` on the CPU, with the CRC off and on; random
SMR quantized to 0.5 dB (ties), with the scfsi random, for Layer II's five
allocation tables and Layer I at MPEG-1 and LSF rates, stereo, joint and
mono, the CRC off and on, each with forced rows (+-inf, NaN, silent
frames, Layer I's limit); and frames that take every subband to its top
allocation.  On a row with a NaN SMR the lockstep code stops the frame
at its argmin, where the oracle skips the lane (``small > mnr`` is false
for NaN): K5 follows the lockstep code, so the oracles are compared on
the rows without NaN.  The greedy steps: the model's longest frame's,
plus one, are the lockstep loop's rounds.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mp3tpu.numpy_ref import layer12 as oracle
from mp3tpu.ops import jaxlayer12 as J
from mp3tpu.tables import layer12 as JT
from mp3tpu_torch import encoder as E
from mp3tpu_torch.config import EncoderConfig
from mp3tpu_torch.ops import alloc12 as A12
from mp3tpu_torch.runtime.wav import read_wav
from mp3tpu_torch.tables import layer12 as T
from mp3tpu_torch.tables import mpeg
from test_torch_layer12_card import (FIXTURES, alloc_cases, lockstep_rounds,
                                     model_alloc, plain_of, rung)

torch.set_num_threads(1)

CASES = alloc_cases()


def oracle_frame(smr, scf, layer, table, nch, sblimit, adb,
                 error_protection, joint, mode):
    """One frame through ``numpy_ref/layer12``'s sequential code, as its
    ``encode`` runs it: (ba (2, 32), adb_left, mode, mode_ext,
    jsbound)."""
    alloc = JT.ALLOC[table] if layer == 2 else None
    perm = np.asarray(smr, np.float64)
    scfsi = None if scf is None else np.asarray(scf, np.int64)

    def req(jb):
        if layer == 2:
            return oracle._bits_for_nonoise_II(perm, scfsi, nch, sblimit, jb,
                                               alloc, error_protection)
        return oracle._bits_for_nonoise_I(perm, nch, jb)

    jsbound = sblimit if layer == 2 else 32
    mode_ext = 0
    if joint:
        mode = mpeg.MODE_STEREO
        if req(jsbound) > adb:
            mode, mode_ext = mpeg.MODE_JOINT, 4
            while True:
                mode_ext -= 1
                jsbound = int(JT.JSB_TABLE[layer - 1][mode_ext])
                if not (req(jsbound) > adb and mode_ext > 0):
                    break
    if layer == 2:
        ba, left = oracle._a_bit_allocation_II(
            perm, scfsi, adb, nch, sblimit, jsbound, alloc, error_protection)
    else:
        ba, left = oracle._a_bit_allocation_I(perm, adb, nch, jsbound,
                                              error_protection)
    return ba, left, mode, mode_ext, jsbound


def check(smr, scf, kw):
    """The model == the lockstep plain version on every output, the
    model's steps == the lockstep rounds, and == the oracles on the rows
    without NaN.  Returns the model's outputs."""
    got = model_alloc(smr, scf, **kw)
    want = plain_of(smr, scf, kw)
    for k in A12.OUTPUTS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["steps"].max() + 1 == lockstep_rounds(
        smr, scf, kw, want["jsbound"].astype(np.int64))
    for f in range(smr.shape[0]):
        if np.isnan(smr[f]).any():
            continue
        ba, left, mode, ext, jsb = oracle_frame(
            smr[f], None if scf is None else scf[f], **kw)
        np.testing.assert_array_equal(got["ba"][f], ba, err_msg=f"frame {f}")
        assert (got["adb_left"][f], got["mode"][f], got["mode_ext"][f],
                got["jsbound"][f]) == (left, mode, ext, jsb), f
    return got


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_model_equals_alloc12_and_the_oracles(case):
    label, smr, scf, kw = case
    got = check(smr, scf, kw)
    if "to its top" in label:
        maxba = A12.kernel_tables(kw["layer"], kw["table"])[1][:32]
        top = 32 if kw["layer"] == 1 else kw["sblimit"]
        for ch in range(kw["nch"]):
            np.testing.assert_array_equal(got["ba"][:, ch, :top],
                                          np.broadcast_to(maxba[:top],
                                                          (2, top)))


_ANALYSES = {}


def jax_analysis(name, layer, mode, kbps, crc):
    """The JAX package's ``analyze_frames`` of a fixture on the CPU, and
    ``allocate``'s keyword arguments: (smr (F, 2, 32) float64, scfsi
    (F, 2, 32) int32 or None, kw)."""
    pcm, rate = read_wav(os.path.join(os.path.dirname(__file__), "golden",
                                      f"{name}.wav"))
    if mode == mpeg.MODE_MONO:
        pcm = pcm[:, :1]
    cfg = EncoderConfig(layer=layer, mode=mode, bitrate_kbps=kbps,
                        sample_rate_hz=rate, error_protection=crc)
    P, x = E._layer12_frame(pcm, cfg)
    x = x.astype(np.float32)            # JAX frames float32 PCM
    key = (name, mode, kbps)
    if key not in _ANALYSES:
        fb = (np.concatenate([np.zeros((P.nch, 64), x.dtype), x[:, :-64]],
                             axis=1) if layer == 1 else x)
        ana = J.analyze_frames(jnp.asarray(x), jnp.asarray(fb), layer,
                               P.table, P.sblimit, P.nch, P.F, P.sfreq_hz)
        snr = np.asarray(ana["snr"], np.float64)
        scfsi = np.asarray(ana["scfsi"]) if layer == 2 else None
        _ANALYSES[key] = (snr, scfsi)
    snr, scfsi = _ANALYSES[key]
    nch = P.nch
    smr = np.stack([snr[0], snr[nch - 1]], axis=1)
    scf = (np.stack([scfsi[0], scfsi[nch - 1]], axis=1).astype(np.int32)
           if layer == 2 else None)
    kw = dict(layer=layer, table=P.table, nch=nch, sblimit=P.sblimit,
              adb=P.adb, error_protection=crc, joint=P.joint, mode=cfg.mode)
    return smr, scf, kw


#: the six fixtures of tests/test_layer12_fast.py, each with the CRC off
#: and on
JAX_FIXTURES = [(name, layer, mode, kbps, crc)
                for name, layer, mode, kbps, _ in FIXTURES[:6]
                for crc in (False, True)]


@pytest.mark.parametrize("case", JAX_FIXTURES,
                         ids=[f"{c[0]}{'_crc' * c[4]}" for c in JAX_FIXTURES])
def test_model_on_the_fixtures_jax_analysis(case):
    smr, scf, kw = jax_analysis(*case)
    got = check(smr, scf, kw)
    if kw["joint"] and case[0] == "l2_noise_j_128":
        assert (got["mode"] == mpeg.MODE_JOINT).any()


@pytest.mark.parametrize("layer,table", [(1, None)] + [(2, t)
                                                       for t in range(5)])
def test_ladders_ascend_so_the_linear_search_is_searchsorted(layer, table):
    dtab, itab = A12.kernel_tables(layer, table)
    ladder, bound = dtab[1024:1536].reshape(32, 16), itab[64:96]
    rng = np.random.RandomState(7)
    keys = np.concatenate([np.round(rng.uniform(-10, 110, 200) * 2) / 2,
                           np.unique(ladder), [np.inf, -np.inf, np.nan]])
    for sb in range(32):
        b = int(bound[sb])
        if b <= 0:
            continue
        assert (np.diff(ladder[sb, :b]) >= 0).all()
        want = np.searchsorted(ladder[sb, :b], keys, side="left")
        got = [rung(ladder[sb], b, x) for x in keys]
        np.testing.assert_array_equal(got, want)
    if layer == 2:
        np.testing.assert_array_equal(
            ladder[:, 0], T.SNR_L2[T.ALLOC[table]["quant"][:, 0]])
