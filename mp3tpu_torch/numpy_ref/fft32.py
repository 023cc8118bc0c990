"""Bit-exact float32 replica of the reference's real split-radix FFT
(subs.c: rsfft/rsrec/srrec/BR_permute, Malvar's algorithm).

The C routines operate scalar-by-scalar in float32; every butterfly is
elementwise across independent lanes, so a vectorized numpy float32
implementation with the same operation order produces bit-identical
results.  The twiddle tables follow subs.c:452-457: the angle is
computed in double, *stored to float*, and the cos/sin of the
float-rounded angle are rounded to float again.

All functions accept a batch of rows: x has shape (..., N).
"""
import numpy as np

TWOPI = 6.28318530717958647692
SQHALF = 0.707106781186547524401

F = np.float32


def _tables(m, three=False):
    """cn, spcn, smcn (and c3n...) for one stage, as float32 arrays
    indexed by n=1..m4-1 with the n==m8 hole kept in place (unused)."""
    m4 = m // 4
    cn = np.zeros(m4, F); spcn = np.zeros(m4, F); smcn = np.zeros(m4, F)
    c3n = np.zeros(m4, F); spc3n = np.zeros(m4, F); smc3n = np.zeros(m4, F)
    for n in range(1, m4):
        if n == m // 8:
            continue
        ang = F(n * TWOPI / m)
        c = F(np.cos(np.float64(ang))); s = F(np.sin(np.float64(ang)))
        cn[n] = c; spcn[n] = F(-(s + c)); smcn[n] = F(s - c)
        ang = F(3 * n * TWOPI / m)
        c = F(np.cos(np.float64(ang))); s = F(np.sin(np.float64(ang)))
        c3n[n] = c; spc3n[n] = F(-(s + c)); smc3n[n] = F(s - c)
    if three:
        return cn, spcn, smcn, c3n, spc3n, smc3n
    return cn, spcn, smcn


_TAB_CACHE = {}


def _get_tables(m, three):
    key = (m, three)
    if key not in _TAB_CACHE:
        _TAB_CACHE[key] = _tables(m, three)
    return _TAB_CACHE[key]


def _srrec(xr, xi, logm):
    """Complex split-radix recursion (subs.c:185-362); xr/xi are views
    of shape (..., m) modified in place."""
    if logm == 0:
        return
    if logm == 1:
        a = xr[..., 0].copy(); b = xr[..., 1].copy()
        xr[..., 0] = a + b; xr[..., 1] = a - b
        a = xi[..., 0].copy(); b = xi[..., 1].copy()
        xi[..., 0] = a + b; xi[..., 1] = a - b
        return
    if logm == 2:
        # subs.c:203-240 explicit radix-4
        t = xr[..., 0] + xr[..., 2]; xr[..., 2] = xr[..., 0] - xr[..., 2]; xr[..., 0] = t
        t = xi[..., 0] + xi[..., 2]; xi[..., 2] = xi[..., 0] - xi[..., 2]; xi[..., 0] = t
        t = xr[..., 1] + xr[..., 3]; xr[..., 3] = xr[..., 1] - xr[..., 3]; xr[..., 1] = t
        t = xi[..., 1] + xi[..., 3]; xi[..., 3] = xi[..., 1] - xi[..., 3]; xi[..., 1] = t
        t = xr[..., 0] + xr[..., 1]; xr[..., 1] = xr[..., 0] - xr[..., 1]; xr[..., 0] = t
        t = xi[..., 0] + xi[..., 1]; xi[..., 1] = xi[..., 0] - xi[..., 1]; xi[..., 0] = t
        t1 = xr[..., 2] + xi[..., 3]
        t2 = xi[..., 2] + xr[..., 3]
        xi[..., 2] = xi[..., 2] - xr[..., 3]
        xr[..., 3] = xr[..., 2] - xi[..., 3]
        xr[..., 2] = t1
        xi[..., 3] = t2
        return

    m = 1 << logm; m2 = m // 2; m4 = m2 // 2; m8 = m4 // 2

    # step 1
    a = xr[..., :m2].copy(); b = xr[..., m2:].copy()
    xr[..., :m2] = a + b; xr[..., m2:] = a - b
    a = xi[..., :m2].copy(); b = xi[..., m2:].copy()
    xi[..., :m2] = a + b; xi[..., m2:] = a - b

    # step 2 (on upper half)
    ur = xr[..., m2:]; ui = xi[..., m2:]
    a = ur[..., :m4] + ui[..., m4:]
    b = ui[..., :m4] + ur[..., m4:]
    ui[..., :m4] = ui[..., :m4] - ur[..., m4:]
    ur[..., m4:] = ur[..., :m4] - ui[..., m4:]
    ur[..., :m4] = a
    ui[..., m4:] = b

    # steps 3&4: twiddles on upper half
    cn, spcn, smcn, c3n, spc3n, smc3n = _get_tables(m, True)
    n = np.arange(1, m4); n = n[n != m8]
    r1 = ur[..., n]; i1 = ui[..., n]
    t2 = cn[n] * (r1 + i1)
    t1 = spcn[n] * r1 + t2
    ur[..., n] = smcn[n] * i1 + t2
    ui[..., n] = t1
    r2 = ur[..., m4 + n]; i2 = ui[..., m4 + n]
    t2 = c3n[n] * (r2 + i2)
    t1 = spc3n[n] * r2 + t2
    ur[..., m4 + n] = smc3n[n] * i2 + t2
    ui[..., m4 + n] = t1
    if m8 >= 1:
        # C sums in float32 first, then multiplies by the double SQHALF
        r1 = ur[..., m8].copy(); i1 = ui[..., m8].copy()
        ur[..., m8] = (SQHALF * (r1 + i1).astype(np.float64)).astype(F)
        ui[..., m8] = (SQHALF * (i1 - r1).astype(np.float64)).astype(F)
        r2 = ur[..., m4 + m8].copy(); i2 = ui[..., m4 + m8].copy()
        ur[..., m4 + m8] = (SQHALF * (i2 - r2).astype(np.float64)).astype(F)
        ui[..., m4 + m8] = (-(SQHALF * (r2 + i2).astype(np.float64))).astype(F)

    _srrec(xr[..., :m2], xi[..., :m2], logm - 1)
    _srrec(xr[..., m2:m2 + m4], xi[..., m2:m2 + m4], logm - 2)
    _srrec(xr[..., m2 + m4:], xi[..., m2 + m4:], logm - 2)


def _rsrec(x, logm):
    """Real-input split-radix recursion (subs.c:412-523), in place."""
    if logm == 0:
        return
    if logm == 1:
        a = x[..., 0].copy(); b = x[..., 1].copy()
        x[..., 0] = a + b; x[..., 1] = a - b
        return
    m = 1 << logm; m2 = m // 2; m4 = m2 // 2; m8 = m4 // 2

    # step 1
    a = x[..., :m2].copy(); b = x[..., m2:].copy()
    x[..., :m2] = a + b; x[..., m2:] = a - b

    # step 2: negate x[m2+m4 : m]
    x[..., m2 + m4:] = -x[..., m2 + m4:]

    # steps 3&4
    cn, spcn, smcn = _get_tables(m, False)
    xr1 = x[..., m2:m2 + m4]; xi1 = x[..., m2 + m4:]
    n = np.arange(1, m4); n = n[n != m8]
    r = xr1[..., n]; i = xi1[..., n]
    t2 = cn[n] * (r + i)
    t1 = spcn[n] * r + t2
    xr1[..., n] = smcn[n] * i + t2
    xi1[..., n] = t1
    if m8 >= 1:
        r = xr1[..., m8].copy(); i = xi1[..., m8].copy()
        xr1[..., m8] = (SQHALF * (r + i).astype(np.float64)).astype(F)
        xi1[..., m8] = (SQHALF * (i - r).astype(np.float64)).astype(F)

    _rsrec(x[..., :m2], logm - 1)
    _srrec(x[..., m2:m2 + m4], x[..., m2 + m4:], logm - 2)

    # step 5: sign change and reorder (subs.c:504-522)
    for nn in range(m8):
        i1 = m2 + m4 + nn
        i2 = m - 1 - nn
        t = x[..., i1].copy()
        x[..., i1] = -x[..., i2]
        x[..., i2] = -t
    for nn in range(m8):
        i1 = m2 + 1 + 2 * nn
        i2 = m - 2 - 2 * nn
        t = x[..., i1].copy()
        x[..., i1] = -x[..., i2]
        x[..., i2] = t
    if logm == 2:
        x[..., 3] = -x[..., 3]


def _br_perm(logm):
    """Bit-reversal permutation as produced by BR_permute (subs.c:136-177)."""
    lg2 = logm >> 1
    n = 1 << lg2
    if logm & 1:
        lg2 += 1
    brseed = np.zeros(1 << lg2, np.int64)
    brseed[0] = 0
    brseed[1] = 1
    for j in range(2, lg2 + 1):
        imax = 1 << (j - 1)
        for i in range(imax):
            brseed[i] <<= 1
            brseed[i + imax] = brseed[i] + 1
    x = np.arange(1 << logm)
    for off in range(1, n):
        fj = n * brseed[off]
        i, j = off, fj
        x[i], x[j] = x[j], x[i]
        for gno in range(1, brseed[off]):
            i += n
            j = fj + brseed[gno]
            x[i], x[j] = x[j], x[i]
    return x


_BR_CACHE = {}


def rsfft(x):
    """Real split-radix FFT of float32 rows; returns packed spectrum
    like the C rsfft: out[0..N/2] real parts, out[N/2+1..N-1] such that
    Im(X_i) corresponds to -out[N-i] (see enphinew, subs.c:53-122)."""
    x = np.ascontiguousarray(x, F).copy()
    N = x.shape[-1]
    logm = int(N).bit_length() - 1
    assert 1 << logm == N
    _rsrec(x, logm)
    if logm > 1:
        if logm not in _BR_CACHE:
            _BR_CACHE[logm] = _br_perm(logm)
        x = x[..., _BR_CACHE[logm]]
    return x


def energy_phi(x):
    """enphinew (subs.c:53-122): energy and phase with the 0.0005 floor.

    x: packed rsfft output (..., N) float32.
    Returns energy (..., N//2+1) float64, phi (..., N//2+1) float64
    (values are exactly the reference's float32 results, widened).
    """
    N = x.shape[-1]
    h = N // 2
    re = x[..., :h + 1]
    im = np.concatenate(
        [np.zeros_like(x[..., :1]), -x[..., :h:-1],
         np.zeros_like(x[..., :1])], axis=-1)  # im[i] = -x[N-i], i=1..h-1
    energy = re * re + im * im  # float32 ops, as in C
    phi = np.arctan2(im.astype(np.float64), re.astype(np.float64)).astype(F)
    floor = energy.astype(np.float64) < 0.0005
    floor[..., 0] = False
    floor[..., h] = False
    energy = np.where(floor, F(0.0005), energy)
    phi = np.where(floor, F(0.0), phi)
    # ends: energy = re^2, phi = atan2(0, re)
    energy[..., 0] = re[..., 0] * re[..., 0]
    energy[..., h] = re[..., h] * re[..., h]
    phi[..., 0] = np.arctan2(0.0, re[..., 0].astype(np.float64)).astype(F)
    phi[..., h] = np.arctan2(0.0, re[..., h].astype(np.float64)).astype(F)
    return energy.astype(np.float64), phi.astype(np.float64)
