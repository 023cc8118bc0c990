"""The benchmark's PCM, made from ``--seed``: ``programme``, a signal
with the parts that make an encoder work as it does on music -- tonal
partials at pitches set by the seed (the masking thresholds and the bit
allocation), broadband noise, and percussive onsets on a 120 bpm grid
(psy model 2's attack detection, so Layer III switches some granules
to short blocks, which the tones and noise of
``mp3tpu_torch/tools/signals.py`` never make it do).  The seed changes
the signal, never its length.
"""
import math

import torch


def programme(seed, seconds, rate, device, nch=2, partials=6, noise=0.02,
              onset_level=0.5, bpm=120.0, onset_decay_s=0.03, level=0.45):
    """int16 numpy (nch, seconds * rate), made on `device` from `seed`
    with a ``torch.Generator`` there: per channel `partials` sines at
    whole-Hz pitches drawn between 110 Hz and 3.5 kHz with slow tremolo,
    white noise at `noise`, and on the `bpm` grid (phase drawn from the
    seed) a noise burst of peak `onset_level` decaying with time
    constant `onset_decay_s`; scaled by `level` of full scale.  The same
    seed on the same kind of device gives the same PCM."""
    g = torch.Generator(device).manual_seed(int(seed))
    n = int(round(seconds * rate))
    idx = torch.arange(n, device=device, dtype=torch.int64)
    t = idx.to(torch.float64) / rate
    beat = 60.0 / bpm
    phase = float(torch.rand(1, generator=g, device=device)) * beat
    env = torch.exp(-torch.remainder(t - phase, beat) / onset_decay_s)
    out = torch.empty(nch, n, dtype=torch.int16, device=device)
    for ch in range(nch):
        u = torch.rand(4, partials, generator=g, device=device,
                       dtype=torch.float64)
        freqs = torch.round(110.0 * 2.0 ** (5.0 * u[0])).to(torch.int64)
        amps = (0.3 + 0.7 * u[1]) / partials
        trem = 0.1 + 0.6 * u[2]
        ph = 2 * math.pi * u[3]
        x = torch.zeros(n, dtype=torch.float64, device=device)
        for k in range(partials):
            # whole-Hz pitches: the phase is exact however long the clip
            cyc = torch.remainder(freqs[k] * idx, rate).to(torch.float64)
            x += (amps[k] * (0.75 + 0.25 * torch.sin(
                2 * math.pi * trem[k] * t + ph[k]))
                * torch.sin(2 * math.pi * cyc / rate + ph[k]))
        x += noise * torch.randn(n, generator=g, device=device,
                                 dtype=torch.float64)
        x += onset_level * env * torch.randn(n, generator=g, device=device,
                                             dtype=torch.float64)
        out[ch] = torch.clamp(torch.round(x * (level * 32767)), -32768,
                              32767).to(torch.int16)
    return out.cpu().numpy()
