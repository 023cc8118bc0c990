"""The port's MPEG-2 LSF Layer III streams against the benchmark's plain
reference (``mp3bench/ref``, written from ISO/IEC 13818-3; it imports
nothing of the port), on the CPU: programme PCM from seeds through
``encode_layer3_fast`` at 24, 22.05 and 16 kHz, each stream judged by
``mp3bench.check.judge`` with every frame in depth -- no structural
fault, and the quantized lines those that the reference derives from the
PCM under the stream's own decisions.  The port's LSF band edges are the
standard's Table B.2 at all three rates.  At 24 kHz the ISO reference
software's long edge 330 (the standard: 332) gives lines 330-331 of a
long block the wrong band's scale factor; at 96 kbps enough of those
lines are coded for the 24 kHz / 96k case to fail with it.

The fixture ``jax_standard_24k`` lets the tests that hold the port's
tables to the JAX package's compare at 24 kHz: the package keeps 330."""
import numpy as np
import pytest
import torch

from mp3bench import check
from mp3bench.entries import encoder_config
from mp3bench.ref import tables as ref_tables
from mp3bench.signals import programme
from mp3tpu_torch.encoder import encode_layer3_fast
from mp3tpu_torch.tables import mpeg

torch.set_num_threads(1)

#: the largest mismatch a sound stream may show, parts per million
MISMATCH_PPM = 5.0
#: (rate Hz, kbps, mode, seconds, seeds)
CASES = [
    (24000, 64, "stereo", 4.0, (2 ** 31 + 101, 7)),
    (24000, 96, "stereo", 6.0, (2 ** 31 + 103, 11)),
    (24000, 64, "mono", 4.0, (2 ** 31 + 107,)),
    (22050, 56, "stereo", 4.0, (2 ** 31 + 109,)),
    (16000, 32, "stereo", 4.0, (2 ** 31 + 113,)),
]


@pytest.fixture
def jax_standard_24k():
    """The JAX package's scale factor bands given ISO/IEC 13818-3 Table
    B.2's 24 kHz long edge 332, for one test and in memory: the package
    keeps the ISO reference software's 330, the port the standard's, so
    a test that holds the port's 24 kHz tables to the package's compares
    them with the package's own derivation from the standard's edge.
    The caches derived from the bands are cleared before and after."""
    from mp3tpu.ops import jaxloop, jaxpsy
    from mp3tpu.tables import mpeg as jmpeg
    from mp3tpu.tables import psy as jpsy
    caches = (jpsy.psy_params_for_sfreq, jaxpsy._psy_mats, jaxloop._static)
    i = jmpeg.sfband_index(jmpeg.MPEG2_LSF, 1)
    bands = [dict(b) for b in jmpeg.SFBAND]
    bands[i]["l"] = list(bands[i]["l"])
    assert bands[i]["l"][18] == 330
    bands[i]["l"][18] = 332
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmpeg, "SFBAND", bands)
        for c in caches:
            c.cache_clear()
        yield
    for c in caches:
        c.cache_clear()


def _config(rate, kbps, mode):
    return dict(layer=3, mode=mode, channels=1 if mode == "mono" else 2,
                bitrate_kbps=kbps, sample_rate_hz=rate, crc=False,
                psy_model=2, padding=False)


@pytest.mark.parametrize("rate,kbps,mode,seconds,seeds", CASES,
                         ids=[f"{r}-{k}k-{m}" for r, k, m, _, _ in CASES])
def test_lsf_streams_match_the_reference(rate, kbps, mode, seconds, seeds):
    config = _config(rate, kbps, mode)
    cfg = encoder_config(config)
    assert cfg.finalize().version == mpeg.MPEG2_LSF
    for seed in seeds:
        pcm = programme(seed, seconds, rate, torch.device("cpu"),
                        nch=config["channels"])
        stream = encode_layer3_fast(pcm, cfg, "cpu")
        r = check.judge(config, [(pcm, stream)], 10 ** 6, [seed, 2])
        assert r["bad_frames"] == 0, r["faults"]
        assert r["compared"] > 0
        assert r["mismatch_ppm"] <= MISMATCH_PPM, (seed, r["mismatch_ppm"])


@pytest.mark.parametrize("rate", sorted(ref_tables.LSF_SAMPLE_RATE_INDEX))
def test_lsf_band_edges_are_the_standards(rate):
    sf = ref_tables.LSF_SAMPLE_RATE_INDEX[rate]
    assert mpeg.S_FREQ_KHZ[mpeg.MPEG2_LSF][sf] * 1000 == rate
    np.testing.assert_array_equal(mpeg.sfb_long(mpeg.MPEG2_LSF, sf),
                                  ref_tables.SFB_LONG[rate])
    np.testing.assert_array_equal(mpeg.sfb_short(mpeg.MPEG2_LSF, sf),
                                  ref_tables.SFB_SHORT[rate])
