"""The port's Woodbury algebra (``ops/woodbury.py``), likelihood model
(``infer/model.py``), Wiener reconstruction and schema against the JAX
package, on the CPU at float64.

Same inputs (made from a seed with numpy) through both packages: every
woodbury function within 1e-12 relative of the JAX one (their sums run in
other orders, so not bit for bit); ``woodbury_lnlike`` within 1e-10 of a
dense float64 covariance oracle, with and without ECORR epoch blocks; the
closed-form phi gradient within 1e-6 of central finite differences; the
model's basis and phi within 1e-12 of the JAX model's; the Wiener filter
within 1e-8 of the dense smoother; the JSON wire form loads across the two
packages unchanged.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fakepta_tpu.batch import PulsarBatch as JaxBatch
from fakepta_tpu.infer import model as jmodel
from fakepta_tpu.infer import reconstruct as jrec
from fakepta_tpu.infer import schema as jschema
from fakepta_tpu.ops import woodbury as jwb
from fakepta_tpu_torch.batch import PulsarBatch
from fakepta_tpu_torch.infer import model as tmodel
from fakepta_tpu_torch.infer import reconstruct as trec
from fakepta_tpu_torch.infer import schema as tschema
from fakepta_tpu_torch.ops import woodbury as twb

RTOL = 1e-12
ORACLE_RTOL = 1e-10
KW = dict(npsr=8, ntoa=64, tspan_years=10.0, toaerr=1e-7, n_red=8, n_dm=8,
          seed=1)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, rtol=RTOL, what="", scale=None):
    """Within ``rtol`` of ``scale`` (default max|want|): a value that is a
    difference of larger terms (lnnorm = ln det B + ln det Sigma) is held
    to the size of its terms."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


@pytest.fixture(scope="module")
def problem():
    """One pulsar's f64 Woodbury inputs with padding and ECORR epochs
    (some without ECORR), three residual realizations."""
    rng = np.random.default_rng(2024)
    T, M2, n_ep = 48, 10, 12
    mask = np.ones(T, bool)
    mask[-6:] = False
    epoch = np.repeat(np.arange(n_ep), T // n_ep)
    u = np.zeros(T)
    for e in range(n_ep):
        if e % 3:
            u[epoch == e] = rng.uniform(1e-8, 1e-7)
    u[~mask] = 0.0
    return dict(
        T=T, n_ep=n_ep, mask=mask, epoch=epoch, u=u,
        sigma2=rng.uniform(0.5, 2.0, T) * 1e-14,
        tmat=rng.standard_normal((T, M2)) * 1e-4,
        phi=10.0 ** rng.uniform(-16, -13, M2),
        r=rng.standard_normal((3, T)) * 1e-7)


def _parts(pkg, pr, ecorr, conv):
    ep = pr["T"] if ecorr else 0
    args = (conv(pr["tmat"]), conv(pr["sigma2"]), conv(pr["mask"]),
            conv(pr["epoch"]) if ecorr else None,
            conv(pr["u"]) if ecorr else None)
    fixed = pkg.fixed_parts(*args, num_epochs=ep)
    res = [pkg.res_parts(conv(pr["r"][i]), *args, num_epochs=ep)
           for i in range(3)]
    return fixed, res


def _moments(pkg, pr, ecorr, conv):
    fixed, res = _parts(pkg, pr, ecorr, conv)
    M, lndetN, nv, corr = pkg.finish_fixed(fixed)
    fin = [pkg.finish_res(rp, corr) for rp in res]
    return M, lndetN, nv, fin


@pytest.mark.parametrize("ecorr", [False, True], ids=["white", "ecorr"])
def test_parts_and_finish_match_jax(problem, ecorr):
    ft, rt = _parts(twb, problem, ecorr, _t)
    fj, rj = _parts(jwb, problem, ecorr, jnp.asarray)
    assert ft.keys() == fj.keys()
    for k in fj:
        _close(ft[k], fj[k], what=f"fixed {k}")
    for a, b in zip(rt, rj):
        assert a.keys() == b.keys()
        for k in b:
            _close(a[k], b[k], what=f"res {k}")
    mt, mj = _moments(twb, problem, ecorr, _t), _moments(jwb, problem,
                                                         ecorr, jnp.asarray)
    for i, what in enumerate(("M", "lndetN", "n_valid")):
        _close(mt[i], mj[i], what=what)
    for (d0a, dTa), (d0b, dTb) in zip(mt[3], mj[3]):
        _close(d0a, d0b, what="d0")
        _close(dTa, dTb, what="dT")


@pytest.mark.parametrize("ecorr", [False, True], ids=["white", "ecorr"])
def test_lnlike_pieces_match_jax(problem, ecorr):
    M, lndetN, nv, fin = _moments(twb, problem, ecorr, _t)
    Mj, lndetNj, nvj, finj = _moments(jwb, problem, ecorr, jnp.asarray)
    phi = problem["phi"]
    chol, lnnorm = twb.lnlike_factors(M, _t(phi))
    cholj, lnnormj = jwb.lnlike_factors(Mj, jnp.asarray(phi))
    _close(chol, cholj, what="chol")
    lnphi = np.abs(np.log(phi)).sum()       # ln det B: lnnorm's terms' size
    _close(lnnorm, lnnormj, what="lnnorm", scale=lnphi)
    dT = torch.stack([f[1] for f in fin])[:, None]            # (R, 1, 2M)
    dTj = jnp.stack([f[1] for f in finj])[:, None]
    _close(twb.quad_forms(chol[None], dT),
           jwb.quad_forms(cholj[None], dTj), what="quad_forms")
    for (d0, dTr), (d0j, dTj1) in zip(fin, finj):
        _close(twb.lnlike_from_moments(d0, dTr, M, lndetN, nv, _t(phi)),
               jwb.lnlike_from_moments(d0j, dTj1, Mj, lndetNj, nvj,
                                       jnp.asarray(phi)), what="lnl")
        lt, gt = twb.lnlike_and_grad_phi(M, _t(phi), d0, dTr, lndetN, nv)
        lj, gj = jwb.lnlike_and_grad_phi(Mj, jnp.asarray(phi), d0j, dTj1,
                                         lndetNj, nvj)
        _close(lt, lj, what="lnl+grad value")
        # each entry is a difference of terms up to 1/phi_j in size
        _close(gt, gj, what="grad phi", scale=np.abs(1.0 / phi).max())
        _close(twb.conditional_mean(M, _t(phi), dTr),
               jwb.conditional_mean(Mj, jnp.asarray(phi), dTj1),
               what="conditional mean")
    # a zero prior variance is floored, not divided by
    phi0 = phi.copy()
    phi0[0] = 0.0
    _close(twb.lnlike_factors(M, _t(phi0))[1],
           jwb.lnlike_factors(Mj, jnp.asarray(phi0))[1], what="floored",
           scale=np.abs(np.log(np.maximum(phi0, 1e-300))).sum())
    assert twb._phi_floor(torch.float32) == pytest.approx(
        float(jwb._phi_floor(jnp.float32)), rel=1e-6)


@pytest.mark.parametrize("ecorr", [False, True], ids=["white", "ecorr"])
def test_woodbury_lnlike_matches_jax_and_dense_oracle(problem, ecorr):
    pr = problem
    blocks = []
    if ecorr:
        for e in range(pr["n_ep"]):
            sel = (pr["epoch"] == e) & pr["mask"]
            blocks.append((sel, pr["u"][sel]))
    for r in pr["r"]:
        kw_t = dict(mask=_t(pr["mask"]))
        kw_j = dict(mask=jnp.asarray(pr["mask"]))
        if ecorr:
            kw_t.update(epoch_idx=_t(pr["epoch"]), ecorr_amp=_t(pr["u"]),
                        num_epochs=pr["T"])
            kw_j.update(epoch_idx=jnp.asarray(pr["epoch"]),
                        ecorr_amp=jnp.asarray(pr["u"]), num_epochs=pr["T"])
        got = twb.woodbury_lnlike(_t(r), _t(pr["tmat"]), _t(pr["phi"]),
                                  _t(pr["sigma2"]), **kw_t)
        want = jwb.woodbury_lnlike(jnp.asarray(r), jnp.asarray(pr["tmat"]),
                                   jnp.asarray(pr["phi"]),
                                   jnp.asarray(pr["sigma2"]), **kw_j)
        _close(got, want, what="vs jax")
        oracle = _dense_lnl(r, pr["tmat"], pr["phi"], pr["sigma2"],
                            pr["mask"], blocks)
        _close(got, oracle, rtol=ORACLE_RTOL, what="vs dense")


def _dense_lnl(r, tmat, phi, sigma2, mask, blocks=()):
    """f64 dense-covariance oracle: C = N + T diag(phi) T^T over valid
    TOAs, ECORR rank-1 epoch blocks added to N."""
    v = np.asarray(mask, bool)
    N = np.diag(np.asarray(sigma2)[v])
    for sel, u in blocks:
        idx = np.flatnonzero(sel[v])
        N[np.ix_(idx, idx)] += np.outer(u, u)
    Tm = np.asarray(tmat)[v]
    C = N + Tm @ np.diag(np.asarray(phi)) @ Tm.T
    _, ld = np.linalg.slogdet(C)
    x = np.linalg.solve(C, np.asarray(r)[v])
    return -0.5 * (np.asarray(r)[v] @ x + ld + v.sum() * np.log(2 * np.pi))


def test_grad_phi_matches_finite_differences(problem):
    """The closed-form gradient against central differences in ln phi,
    Richardson-extrapolated (steps 1e-3 and 5e-4: truncation O(h^4)), on
    the three entries with the largest |phi_j dlnL/dphi_j|, at prior
    variances 1e6 times the fixture's (phi_j M_jj ~ 1, where the prior
    moves lnL by O(1), so the differences stand well above its
    rounding). lndetN and n_valid do not depend on phi and are left
    out."""
    M, _, _, fin = _moments(twb, problem, True, _t)
    d0, dT = fin[0]
    zero = torch.zeros((), dtype=torch.float64)
    phi = _t(problem["phi"] * 1e6)
    _, grad = twb.lnlike_and_grad_phi(M, phi, d0, dT, zero, zero)

    def central(j, h):
        up, dn = phi.clone(), phi.clone()
        up[j] *= np.exp(h)
        dn[j] *= np.exp(-h)
        return float(twb.lnlike_from_moments(d0, dT, M, zero, zero, up)
                     - twb.lnlike_from_moments(d0, dT, M, zero, zero,
                                               dn)) / (2 * h)

    for j in torch.argsort((grad * phi).abs(), descending=True)[:3]:
        fd = (4 * central(j, 5e-4) - central(j, 1e-3)) / 3
        np.testing.assert_allclose(float(grad[j] * phi[j]), fd, rtol=1e-5)


def test_epoch_bookkeeping_matches_jax(problem):
    ft, rt = _parts(twb, problem, True, _t)
    fj, rj = _parts(jwb, problem, True, jnp.asarray)
    # pad_epoch_parts / append_parts on the fixed and the residual dicts
    for a, b in ((ft, fj), (rt[0], rj[0])):
        pa = twb.pad_epoch_parts(a, problem["T"] + 5)
        pb = jwb.pad_epoch_parts(b, problem["T"] + 5)
        for k in pb:
            _close(pa[k], pb[k], what=f"pad {k}")
        with pytest.raises(ValueError, match="shrink"):
            twb.pad_epoch_parts(a, 2)
    pr = problem
    half = pr["T"] // 2

    def args(pkg_conv, lo, hi):
        return dict(tmat=pkg_conv(pr["tmat"][lo:hi]),
                    sigma2=pkg_conv(pr["sigma2"][lo:hi]),
                    mask=pkg_conv(pr["mask"][lo:hi]),
                    epoch_idx=pkg_conv(pr["epoch"][lo:hi]),
                    ecorr_amp=pkg_conv(pr["u"][lo:hi]), num_epochs=pr["T"])
    for pkg, conv in ((twb, _t), (jwb, jnp.asarray)):
        a = args(conv, 0, half)
        head = pkg.fixed_parts(**a)
        whole = pkg.append_parts(head, **args(conv, half, pr["T"]))
        full = pkg.fixed_parts(**args(conv, 0, pr["T"]))
        for k in full:
            _close(np.asarray(whole[k]), np.asarray(full[k]), what=k)
    with pytest.raises(ValueError, match="requires r"):
        twb.append_parts(rt[0], **args(_t, 0, half))
    with pytest.raises(ValueError, match="forbids r"):
        twb.append_parts(ft, r=_t(pr["r"][0][:half]), **args(_t, 0, half))


def test_restrict_coupling_and_cho_solve_match_jax(problem):
    M, lndetN, nv, fin = _moments(twb, problem, False, _t)
    Mj, lndetNj, nvj, finj = _moments(jwb, problem, False, jnp.asarray)
    cols = [0, 2, 5, 9]
    got = twb.restrict_moments((M, lndetN, nv, *fin[0]), cols)
    want = jwb.restrict_moments((Mj, lndetNj, nvj, *finj[0]), cols)
    for g, w in zip(got, want):
        _close(g, w, what="restrict")
    blocks = [np.arange(0, 4), np.arange(4, 7), np.arange(7, 10)]
    _close(twb.block_coupling(M, blocks), jwb.block_coupling(Mj, blocks),
           what="coupling")
    b = np.random.default_rng(3).standard_normal((10, 2))
    _close(twb.cho_solve_psd(M, _t(b)),
           jwb.cho_solve_psd(Mj, jnp.asarray(b)), rtol=1e-9, what="cho")
    # a factorization that fails gives NaN without a host sync
    assert torch.isnan(twb.cho_solve_psd(-M, _t(b))).all()


# -- the likelihood model ---------------------------------------------------

@pytest.fixture(scope="module")
def batches():
    """The synthetic batch at f64 in both packages, with two system bands
    and chromatic frequencies switched on."""
    jb = JaxBatch.synthetic(**KW, dtype=jnp.float64)
    leaves = {k: np.array(getattr(jb, k)) for k in jb.__dataclass_fields__}
    p, t = leaves["t_own"].shape
    leaves["freqs"] = np.tile(np.where(np.arange(t) % 3 == 0, 800.0, 1400.0),
                              (p, 1))
    leaves["sys_psd"] = np.full((p, 2, 4), 1e-12)
    sys_mask = np.zeros((p, 2, t), bool)
    sys_mask[:, 0, ::2] = True
    sys_mask[:, 1, 1::2] = True
    leaves["sys_mask"] = sys_mask
    return (JaxBatch(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            PulsarBatch.from_numpy(leaves, device="cpu",
                                   dtype=torch.float64))


def _models(pkg):
    C, F, L = pkg.ComponentSpec, pkg.FreeParam, pkg.LikelihoodSpec
    return {
        "curn": L(components=(
            C("red", spectrum="batch"), C("dm", spectrum="batch"),
            C("curn", nbin=8, free=(F("log10_A", (-13.8, -12.6)),
                                    F("gamma", (2.0, 6.0)))))),
        "per_pulsar": L(components=(
            C("red", free=(F("log10_A", (-15.0, -13.0), per_pulsar=True),),
              fixed={"gamma": 13 / 3}),
            C("chrom", nbin=4, fixed={"log10_A": -14.0, "gamma": 3.0}))),
        "per_bin": L(components=(
            C("dm", spectrum="batch"),
            C("curn", spectrum="free_spectrum", nbin=4, bin_offset=2,
              free=(F("log10_rho", (-9.0, -6.0), per_bin=True),)))),
        "sys": L(components=(
            C("sys", spectrum="batch"),
            C("red", spectrum="turnover", nbin=6,
              free=(F("log10_A", (-15.0, -13.0)), F("gamma", (2.0, 6.0))),
              fixed={"lf0": -8.5}))),
    }


def _theta(name, d):
    rng = np.random.default_rng(len(name))
    if name == "per_bin":
        return rng.uniform(-9.0, -6.0, d)
    if name == "per_pulsar":
        return rng.uniform(-15.0, -13.0, d)
    return np.array([-13.2, 4.0][:d])


@pytest.mark.parametrize("name", ["curn", "per_pulsar", "per_bin", "sys"])
def test_model_basis_and_phi_match_jax(batches, name):
    jb, tb = batches
    ct = tmodel.build(_models(tmodel)[name], tb)
    cj = jmodel.build(_models(jmodel)[name], jb)
    assert ct.D == cj.D and ct.ncols == cj.ncols
    assert ct.param_names == cj.param_names
    assert ct.column_slices() == cj.column_slices()
    np.testing.assert_array_equal(ct.bounds, cj.bounds)
    _close(ct.basis(tb), cj.basis(jb), what="basis")
    th = _theta(name, ct.D)
    _close(ct.phi(torch.as_tensor(th), tb), cj.phi(jnp.asarray(th), jb),
           what="phi")
    # a psr shard's rows of phi from its offset
    if name == "per_pulsar":
        rows = PulsarBatch.from_numpy(
            {k: v[4:] if k != "tspan_common" else v
             for k, v in tb.numpy().items()}, device="cpu",
            dtype=torch.float64)
        _close(ct.phi(torch.as_tensor(th), rows, psr_offset=4),
               np.asarray(cj.phi(jnp.asarray(th), jb))[4:], what="shard")
    u = np.random.default_rng(0).uniform(size=(3, ct.D))
    np.testing.assert_allclose(ct.theta_from_unit(u), cj.theta_from_unit(u),
                               rtol=1e-15)


def test_priors_and_grid_match_jax():
    mt, mj = _models(tmodel)["curn"], _models(jmodel)["curn"]
    np.testing.assert_array_equal(tmodel.theta_grid(mt, (3, 4)),
                                  jmodel.theta_grid(mj, (3, 4)))
    bounds = np.array([[-13.8, -12.6], [2.0, 6.0]])
    th = np.array([[-13.0, 3.0], [-12.0, 3.0], [-13.5, 5.9]])
    v = np.array([[0.3, -1.2], [2.0, 0.1]])
    for ft, fj, x in (
            (tmodel.box_log_prior, jmodel.box_log_prior, th),
            (tmodel.box_to_unconstrained, jmodel.box_to_unconstrained,
             th[[0, 2]]),
            (tmodel.box_from_unconstrained, jmodel.box_from_unconstrained,
             v)):
        np.testing.assert_allclose(ft(x, bounds).numpy(),
                                   np.asarray(fj(x, bounds)), rtol=1e-14)
    for ft, fj in ((tmodel.box_unconstrained_log_prior,
                    jmodel.box_unconstrained_log_prior),
                   (tmodel.box_unconstrained_log_prior_grad,
                    jmodel.box_unconstrained_log_prior_grad)):
        np.testing.assert_allclose(ft(v).numpy(), np.asarray(fj(v)),
                                   rtol=1e-14)
    assert tmodel.lanes_per_point("fisher", 3) == \
        jmodel.lanes_per_point("fisher", 3) == 13


def test_model_validation_errors(batches):
    tb = batches[1]
    C, F, L = tmodel.ComponentSpec, tmodel.FreeParam, tmodel.LikelihoodSpec
    cases = [
        ("unknown likelihood target", L(components=(C("gwb"),))),
        ("not a hyperparameter", L(components=(C(
            "red", free=(F("log10_a", (-15, -13)),)),))),
        ("batch", L(components=(C("red", spectrum="batch", free=(
            F("log10_A", (-15, -13)),)),))),
        ("common process", L(components=(C("curn", free=(
            F("log10_A", (-15, -13), per_pulsar=True),)),))),
        ("no common-process", L(components=(C("curn",
                                              spectrum="batch"),))),
        ("both free and fixed", L(components=(C(
            "red", free=(F("gamma", (1, 5)),), fixed={"gamma": 3.0}),))),
        ("asks for bins", L(components=(C("red", spectrum="batch",
                                          nbin=20),))),
    ]
    for match, model in cases:
        with pytest.raises(ValueError, match=match):
            tmodel.build(model, tb)
    synthetic = PulsarBatch.synthetic(**KW, device="cpu")
    with pytest.raises(ValueError, match="system-noise"):
        tmodel.build(L(components=(C("sys"),)), synthetic)
    with pytest.raises(ValueError, match="per-pulsar"):
        tmodel.theta_grid(_models(tmodel)["per_pulsar"], 3)
    with pytest.raises(ValueError, match="both"):
        F("x", (0, 1), per_pulsar=True, per_bin=True)
    with pytest.raises(ValueError, match="theta must be"):
        tmodel.build(_models(tmodel)["curn"], tb).validate_theta(
            np.zeros((2, 5)))
    with pytest.raises(TypeError, match="InferSpec"):
        tmodel.as_spec(_models(tmodel)["curn"])


def test_wiener_reconstruct_matches_jax_and_dense(batches):
    jb, tb = batches
    C, L = tmodel.ComponentSpec, tmodel.LikelihoodSpec
    mt = L(components=(C("red", spectrum="batch"), C("dm", spectrum="batch")))
    mj = jmodel.LikelihoodSpec(components=(
        jmodel.ComponentSpec("red", spectrum="batch"),
        jmodel.ComponentSpec("dm", spectrum="batch")))
    r = np.random.default_rng(7).standard_normal((3,) + tuple(
        tb.t_own.shape)) * 1e-7
    got = trec.wiener_reconstruct(mt, tb, r)
    _close(got, jrec.wiener_reconstruct(mj, jb, r), rtol=1e-10, what="jax")
    ct = tmodel.build(mt, tb)
    tmat = ct.basis(tb).numpy()
    phi = ct.phi(np.zeros(0), tb).numpy()
    for p in range(0, tb.npsr, 3):
        S = tmat[p] @ np.diag(phi[p]) @ tmat[p].T
        C64 = np.diag(tb.sigma2[p].numpy()) + S
        want = (S @ np.linalg.solve(C64, r[:, p].T)).T
        np.testing.assert_allclose(got[:, p].numpy(), want, rtol=1e-8,
                                   atol=1e-12 * np.abs(want).max())
    # with ECORR epochs: the JAX filter on the same blocks
    leaves = tb.numpy()
    leaves["epoch_idx"] = np.tile(np.arange(leaves["t_own"].shape[1]) // 2,
                                  (tb.npsr, 1))
    leaves["ecorr_amp"] = np.full(leaves["t_own"].shape, 3e-7)
    te = PulsarBatch.from_numpy(leaves, device="cpu", dtype=torch.float64)
    je = JaxBatch(**{k: jnp.asarray(v) for k, v in leaves.items()})
    _close(trec.wiener_coefficients(mt, te, r, ecorr=True),
           jrec.wiener_coefficients(mj, je, r, ecorr=True), rtol=1e-10,
           what="ecorr")
    with pytest.raises(ValueError, match="pass theta"):
        trec.wiener_coefficients(_models(tmodel)["curn"], tb, r)


@pytest.mark.parametrize("mode", ["lnlike", "grad", "fisher"])
def test_schema_round_trips_across_packages(mode):
    theta = np.array([[-13.2, 4.0], [-13.0, 13 / 3]])
    for name in ("curn", "per_pulsar", "per_bin", "sys"):
        st = tmodel.InferSpec(model=_models(tmodel)[name], theta=theta,
                              mode=mode)
        wire = json.loads(json.dumps(tschema.spec_to_json(st)))
        assert wire["schema"] == tschema.SPEC_SCHEMA == jschema.SPEC_SCHEMA
        # the port's wire form loads in the JAX package, and back
        sj = jschema.spec_from_json(wire)
        assert jschema.spec_to_json(sj) == wire
        back = tschema.spec_from_json(json.loads(json.dumps(
            jschema.spec_to_json(sj))))
        assert tschema.spec_to_json(back) == wire
        assert back.mode == mode
        np.testing.assert_array_equal(back.theta, theta)
        assert tschema.model_to_json(back.model) == jschema.model_to_json(
            jschema.model_from_json(wire["model"]))
    with pytest.raises(ValueError, match="unsupported"):
        tschema.spec_from_json({"schema": "fakepta_tpu.infer-spec/0",
                                "model": [], "theta": []})
    with pytest.raises(ValueError, match="unknown target"):
        tschema.model_from_json([{"target": "gwb"}])
