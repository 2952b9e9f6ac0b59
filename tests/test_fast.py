"""FastTracker (L-periods-per-step steady-state path) vs the per-period
reference path: identical bookkeeping, matching loops and prompts."""
import numpy as np
import jax.numpy as jnp
import pytest

from gnsslib_tpu import sim
from gnsslib_tpu.constants import CodeType, DType
from gnsslib_tpu.nav import NavChannel
from gnsslib_tpu.track import FastTracker, TrackConfig, Tracker

F_SF = 4.092e6
F_IF = 1.023e6
NSAMP = 4092
CFG = TrackConfig(corrn=4, corrd=2, corrp=2)


def _locked_state(doppler=900.0, codei=800, seconds=7.0, cn0=45.0, seed=3):
    rng = np.random.default_rng(5)
    bits = (1 - 2 * rng.integers(0, 2, 512)).astype(np.int8)
    ch = sim.SimChannel(prn=7, doppler=doppler,
                        code_phase=-codei * 1.023e6 / F_SF,
                        carr_phase=0.3, nav_bits=bits)
    noise = sim.noise_std_for_cn0(1.0, cn0, F_SF, DType.REAL)
    data = np.asarray(sim.synthesize([ch], F_SF, F_IF, DType.REAL,
                                     int(seconds * F_SF), noise_std=noise,
                                     seed=seed), np.float32)
    trk = Tracker(CFG, [7], [CodeType.L1CA], F_SF, F_IF, DType.REAL)
    st = trk.init_state()
    st = trk.start_channels(st, [0], [codei], [-doppler])
    block = jnp.asarray(data)
    st, out = trk.run_block(st, block, 5600)
    nav = NavChannel(CodeType.L1CA, 7)
    nav.update(out.ip[:, 0], out.loc[:, 0].astype(np.int64), 0)
    assert nav.flagsync, "test fixture failed to bit-sync"
    st = trk.set_bit_sync(st, 0, nav.sync_offset)
    return trk, st, block


def test_fast_matches_slow_steady_state():
    trk, st, block = _locked_state()
    st_s, out_s = trk.run_block(st, block, 1000)
    ft = FastTracker(trk)
    st_f, out_f = ft.run_block(st, block, 1000)

    # sample bookkeeping identical up to the closed-form vs iterative
    # rounding composition (at most 1 sample, transiently)
    assert np.max(np.abs(out_s.loc - out_f.loc)) <= 1
    assert int(np.asarray(st_s.loc)[0]) == int(np.asarray(st_f.loc)[0])
    assert abs(float(np.asarray(st_s.remcode)[0])
               - float(np.asarray(st_f.remcode)[0])) < 2e-3
    # prompt stream effectively identical
    corr = np.corrcoef(out_s.ip[:, 0], out_f.ip[:, 0])[0, 1]
    assert corr > 0.99, corr
    # carrier loop agrees to well under the noise jitter
    assert out_s.dcarr[-1, 0] == pytest.approx(out_f.dcarr[-1, 0], abs=0.5)
    # exactly one loop-filter update per L periods, at the same periods
    s_upd = np.nonzero(out_s.flagloopfilter[:, 0] == 2)[0]
    f_upd = np.nonzero(out_f.flagloopfilter[:, 0] == 2)[0]
    assert np.array_equal(s_upd, f_upd)


def test_fast_requires_table_and_sync_cadence():
    import dataclasses
    trk = Tracker(dataclasses.replace(CFG, resample="exact"), [7],
                  [CodeType.L1CA], F_SF, F_IF, DType.REAL)
    with pytest.raises(ValueError):
        FastTracker(trk)
    trk2 = Tracker(CFG, [7], [CodeType.L1CA], F_SF, F_IF, DType.REAL)
    ft = FastTracker(trk2)
    with pytest.raises(ValueError):
        ft.run_block(ft.init_state(), jnp.zeros(100000, jnp.float32), 1001)


def test_fast_diag_matches_xla():
    """The Gram-diagonal correlator (_taps_diag) matches the XLA
    einsum formulation through the full FastTracker, including I/Q
    bookkeeping, loop-filter updates, and sample accounting.

    The two runs' f32 states diverge at summation-order level; when the
    code phase drifts across a chip-commensurate table breakpoint
    (4 samples/chip here) that divergence can flip one period's replica
    by a table quantum, so a couple of isolated one-period excursions
    are expected and bounded rather than forbidden."""
    trk, st, block = _locked_state()
    fx = FastTracker(trk, corr="xla")
    fd = FastTracker(trk, corr="diag")
    _, out_x = fx.run_block(st, block, 600)
    _, out_d = fd.run_block(st, block, 600)
    assert np.array_equal(out_x.loc, out_d.loc)
    scale = np.max(np.abs(out_x.ip))
    for a, b in ((out_x.ip, out_d.ip), (out_x.qp, out_d.qp)):
        d = np.abs(a - b)
        outliers = int(np.sum(d > 5e-3 * scale))
        assert outliers <= 3, (outliers, float(d.max()))
        assert np.median(d) < 1e-3 * scale
        corr = np.corrcoef(a[:, 0], b[:, 0])[0, 1]
        assert corr > 0.999, corr
    np.testing.assert_allclose(out_x.dcarr, out_d.dcarr, atol=0.5)
    s_upd = np.nonzero(out_x.flagloopfilter[:, 0] == 2)[0]
    d_upd = np.nonzero(out_d.flagloopfilter[:, 0] == 2)[0]
    assert np.array_equal(s_upd, d_upd)


def test_fast_fused_and_diag2_match_diag():
    """The single-dot diag2 formulation matches the two-dot diag
    correlator through the full FastTracker: same windows, same
    split-Gram layout, same extractor — only summation order and one
    bf16 rounding site differ."""
    trk, st, block = _locked_state()
    fd = FastTracker(trk, corr="diag")
    _, out_d = fd.run_block(st, block, 600)
    scale = np.max(np.abs(out_d.ip))
    fv = FastTracker(trk, corr="diag2")
    _, out_v = fv.run_block(st, block, 600)
    assert np.array_equal(out_d.loc, out_v.loc)
    for a, b in ((out_d.ip, out_v.ip), (out_d.qp, out_v.qp)):
        d = np.abs(a - b)
        outliers = int(np.sum(d > 5e-3 * scale))
        assert outliers <= 3, (outliers, float(d.max()))
        assert np.median(d) < 1e-3 * scale
        c = np.corrcoef(a[:, 0], b[:, 0])[0, 1]
        assert c > 0.999, c
    np.testing.assert_allclose(out_d.dcarr, out_v.dcarr, atol=0.5)


def test_fast_band_tolerates_inactive_channels():
    """An unlocked channel's block-relative loc runs far negative (rebase
    subtracts the advance every block whether or not the channel is
    active) — the GPU's default correlator must still match the xla
    reference on the active channel (receivers track 12 of 32 configured
    PRNs all day)."""
    from gnsslib_tpu.track.fast import default_corr
    trk, st, block = _locked_state()
    trk2 = Tracker(CFG, [7, 8], [CodeType.L1CA] * 2, F_SF, F_IF,
                   DType.REAL)
    st2 = trk2.init_state()
    # drive the (still-inactive) channels' loc far negative, then
    # activate only channel 0 at a sane position
    st2 = trk2.rebase(st2, 40 * trk2.n_nom)
    st2 = trk2.start_channels(st2, [0], [800], [-900.0])
    st2 = trk2.set_bit_sync(st2, 0, 0)
    outs = []
    for corr in ("xla", default_corr("gpu", trk2.smax)):
        f = FastTracker(trk2, corr=corr)
        outs.append(f.run_block(st2, block, 100)[1])    # must not raise
    a, b = outs
    np.testing.assert_array_equal(a.loc[:, 0], b.loc[:, 0])
    scale = np.max(np.abs(a.ip[:, 0])) or 1.0
    assert np.median(np.abs(a.ip[:, 0] - b.ip[:, 0])) < 1e-3 * scale


def test_corr_setter_rejects_wide_split_geometry():
    """diag2 is built on the 64-lane split-Gram layout and would silently
    drop tap terms when 2*smax > 64; the corr setter must refuse such
    geometries (and any unknown formulation)."""
    wide = TrackConfig(corrn=12, corrd=3, corrp=6)      # smax=36
    trkw = Tracker(wide, [7], [CodeType.L1CA], F_SF, F_IF, DType.REAL)
    fw = FastTracker(trkw, corr="xla")
    assert 2 * fw.smax > 64
    fw.corr = "diag"                                    # wide-Gram: fine
    with pytest.raises(ValueError, match="2\\*smax"):
        fw.corr = "diag2"
    with pytest.raises(ValueError, match="expected one of"):
        fw.corr = "band"


@pytest.mark.parametrize("platform,smax,want", [
    ("cpu", 4, "xla"), ("gpu", 4, "diag2"), ("gpu", 36, "diag"),
    ("metal", 4, None)])
def test_default_corr_by_platform(platform, smax, want):
    """The CPU runs the plain reference, the GPU the measured winner
    (diag when the geometry is too wide for the split layout), and an
    unknown platform is refused rather than defaulted."""
    from gnsslib_tpu.track.fast import default_corr
    if want is None:
        with pytest.raises(ValueError, match="platform"):
            default_corr(platform, smax)
    else:
        assert default_corr(platform, smax) == want


def test_fast_default_corr_follows_backend():
    """FastTracker without ``corr`` takes the platform's default."""
    import jax
    from gnsslib_tpu.track.fast import default_corr
    trk = Tracker(CFG, [7], [CodeType.L1CA], F_SF, F_IF, DType.REAL)
    assert FastTracker(trk).corr == default_corr(jax.default_backend(),
                                                 trk.smax)


@pytest.mark.gpu
def test_gpu_default_corr_matches_xla_highest(gpu):
    """On the card: the default correlator against the xla reference at
    HIGHEST matmul precision, with the bounds of
    test_fast_diag_matches_xla (window starts may flip by one sample in
    isolated periods, as chip_smoke.py bounds them)."""
    import jax
    trk, st, block = _locked_state()
    fd = FastTracker(trk)
    assert fd.corr in ("diag", "diag2")
    _, out_d = fd.run_block(st, block, 600)
    with jax.default_matmul_precision("highest"):
        _, out_x = FastTracker(trk, corr="xla").run_block(st, block, 600)
    dloc = np.abs(out_x.loc.astype(np.int64) - out_d.loc)
    assert dloc.max() <= 1 and np.mean(dloc != 0) <= 0.01, \
        (int(dloc.max()), float(np.mean(dloc != 0)))
    scale = np.max(np.abs(out_x.ip))
    for a, b in ((out_x.ip, out_d.ip), (out_x.qp, out_d.qp)):
        d = np.abs(a - b)
        nout = int(np.sum(d > 5e-3 * scale))
        med = float(np.median(d) / scale)
        assert nout <= 3 and med < 1e-3, (nout, med)
    np.testing.assert_allclose(out_x.dcarr, out_d.dcarr, atol=0.5)


def test_exact_selections_per_period():
    """The per-period phase advance reads its table entry exactly: with
    remcode near a code length (1023 chips) a TF32 one-hot dot would be
    ~0.5 chip off; the lookup agrees with float64 NumPy to f32 rounding."""
    from gnsslib_tpu.ops.nco import NSPAN
    trk = Tracker(CFG, [7], [CodeType.L1CA], F_SF, F_IF, DType.REAL)
    trk._consts = dict(trk._consts,
                       code_adv=trk._consts["code_adv"] + 1022.0)
    st = trk.start_channels(trk.init_state(), [0], [0], [0.0])
    block = jnp.asarray(np.random.default_rng(1).integers(
        -8, 8, 3 * NSAMP).astype(np.float32))
    st1, out = trk.run_block(st, block, 1)
    n = int(out.n[0, 0])
    want = np.float64(np.asarray(trk._consts["code_adv"])[
        0, n - trk.n_nom + NSPAN])
    got = float(np.asarray(st1.remcode)[0])
    assert want > 1020.0
    assert abs(got - want) < 2e-4, (got, want)


@pytest.mark.parametrize("sync_offset", [0, 3, 9])
def test_exact_selections_fast_filter(sync_offset):
    """The fast path's loop update reads the cumulative tap sums and the
    update period's code phase at k_c exactly (float64 NumPy reference,
    remcode near 1023 chips)."""
    import jax
    trk = Tracker(CFG, [7], [CodeType.L1CA], F_SF, F_IF, DType.REAL)
    ft = FastTracker(trk, corr="xla")
    st = trk.start_channels(trk.init_state(), [0], [0], [0.0])
    st = trk.set_bit_sync(st, 0, sync_offset)
    carry = trk._state_to_dict(st)
    one = lambda t: jax.tree_util.tree_map(lambda a: a[0], t)
    cc, fc, stc = one(trk._consts), one(ft._fconsts), one(carry)
    block = jnp.zeros(30 * NSAMP, jnp.float32)
    geo = ft._geo_only(block, cc, fc, stc)
    rng = np.random.default_rng(sync_offset)
    L, T = ft.L, CFG.ntaps
    rk = (1023.0 - rng.uniform(0, 0.5, L)).astype(np.float32)
    geo = dict(geo, remcode_k=jnp.asarray(rk))
    cur_i = rng.normal(0, 300, (L, T)).astype(np.float32)
    cur_q = rng.normal(0, 300, (L, T)).astype(np.float32)
    _, out = ft._filter(cc, fc, stc, geo, jnp.asarray(cur_i),
                        jnp.asarray(cur_q))
    k_c = int(out["k_c"])
    assert k_c == (sync_offset - 1) % L
    assert float(out["remcode_u"]) == float(rk[k_c])
    want = np.cumsum(cur_i.astype(np.float64), axis=0)[k_c]
    np.testing.assert_allclose(np.asarray(out["sum_i_u"]), want,
                               rtol=1e-5, atol=1e-2)


def test_fast_diag_matches_xla_iq():
    """Diag correlator with a complex (I/Q-stacked) front end.

    The two formulations' f32 rounding differs (factored vs per-sample
    carrier), and this scenario is chip-commensurate (4 samples/chip):
    once the trajectories drift across a replica-table breakpoint, whole
    periods diverge at full scale — a chaotic amplification, not a
    numerics bug (the round-2 formulation shows the same blowup under a
    different XLA partitioning, and the real-valued fixture above stays
    within 3 outliers over 600 steps).  So: demand exactness on a
    pre-divergence horizon, bulk agreement by median, and that BOTH
    formulations preserve the lock (prompt energy) — the chaotic
    whole-run outlier count itself is not a meaningful statistic."""
    f_sf, f_if, C = 4.092e6, 0.0, 2
    chans = [sim.SimChannel(prn=p, doppler=400.0 * p, code_phase=50.0 * p)
             for p in (2, 9)]
    data = sim.synthesize(chans, f_sf, f_if, DType.IQ, int(1.2 * f_sf),
                          noise_std=1.0, seed=11)
    block = jnp.asarray(np.asarray(data, np.float32))     # (n, 2) I/Q
    trk = Tracker(CFG, [2, 9], [CodeType.L1CA] * C, f_sf, f_if, DType.IQ)
    st = trk.init_state()
    st = trk.start_channels(st, [0, 1], [0, 0], [-400.0, -3600.0])
    st, _ = trk.run_block(st, block, 300)
    for c in range(C):
        st = trk.set_bit_sync(st, c, 0)
    fx = FastTracker(trk, corr="xla")
    fd = FastTracker(trk, corr="diag")
    _, out_x = fx.run_block(st, block, 200)
    _, out_d = fd.run_block(st, block, 200)
    assert np.array_equal(out_x.loc, out_d.loc)
    scale = np.max(np.abs(out_x.ip))
    d = np.abs(out_x.ip - out_d.ip)
    # exact-horizon agreement before chaotic divergence can act
    assert int(np.sum(d[:60] > 5e-3 * scale)) <= 2, float(d[:60].max())
    # bulk agreement over the whole run (full-scale one-period
    # excursions are isolated; the typical period matches)
    assert np.median(d) < 2e-3 * scale
    # both formulations hold the lock: per-channel prompt energy agrees
    # and stays far above the noise floor for the whole run
    e_x = np.mean(np.abs(out_x.ip), axis=0)
    e_d = np.mean(np.abs(out_d.ip), axis=0)
    np.testing.assert_allclose(e_d, e_x, rtol=0.15)
    tail_x = np.mean(np.abs(out_x.ip[-50:]), axis=0)
    tail_d = np.mean(np.abs(out_d.ip[-50:]), axis=0)
    assert np.all(tail_x > 0.3 * e_x) and np.all(tail_d > 0.3 * e_d)


def test_factored_carrier_phase_accuracy():
    """The diag correlator's factored carrier (theta_k + phi_j angle
    addition, _taps_diag) must stay within a bounded phase error of the
    exact f64 carrier across the whole window — a drift-style bug would
    slip past the IQ equivalence test above (whose post-horizon gate
    tolerates chaotic divergence), so the angles are checked directly."""
    rng = np.random.default_rng(4)
    K = 129
    jj64 = np.arange(128, dtype=np.float64)
    kk64 = np.arange(K, dtype=np.float64) * 128.0
    for _ in range(20):
        ftot = np.float32(rng.uniform(-0.5, 0.5))
        rem = np.float32(rng.uniform(0.0, 1.0))
        # factored f32 path, exactly as _taps_diag computes it
        kk = (np.arange(K, dtype=np.float32) * np.float32(128.0))
        th = (2 * np.pi) * (((ftot * kk) % 1.0 + rem) % 1.0)
        ck = np.cos(th, dtype=np.float32)[:, None]
        sk = np.sin(th, dtype=np.float32)[:, None]
        phj = ((2 * np.pi) * (ftot * np.arange(128, dtype=np.float32)))
        cj = np.cos(phj, dtype=np.float32)[None, :]
        sj = np.sin(phj, dtype=np.float32)[None, :]
        cosv = ck * cj - sk * sj
        sinv = sk * cj + ck * sj
        # exact f64 carrier at every sample index
        i64 = kk64[:, None] + jj64[None, :]
        ang = 2 * np.pi * ((np.float64(ftot) * i64 + np.float64(rem))
                           % 1.0)
        # phase error in radians via the chord length
        err = np.hypot(cosv - np.cos(ang), sinv - np.sin(ang))
        # bounded absolutely (3e-4 cycles — far below tracking jitter)..
        assert float(err.max()) < 2e-3, float(err.max())
        # ..and no worse than the direct per-sample f32 form the round-2
        # path used: both share the dominant ftot*i product rounding
        # (which GROWS with i), so the factored form must track it, not
        # add its own drift on top
        i32 = i64.astype(np.float32)
        ang32 = ((2 * np.pi)
                 * (((ftot * i32) % 1.0 + rem) % 1.0)).astype(np.float32)
        err_dir = np.hypot(np.cos(ang32, dtype=np.float32) - np.cos(ang),
                           np.sin(ang32, dtype=np.float32) - np.sin(ang))
        assert float(err.max()) < 2.0 * float(err_dir.max()) + 2e-4, \
            (float(err.max()), float(err_dir.max()))
