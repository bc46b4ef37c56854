"""The reference-compatible facade: a stateful ``Pulsar`` and the array
factories, on the card (port of fakepta_tpu.fake_pta).

API parity with the reference's ``fakepta/fake_pta.py``: the same
constructor signature, the same attribute set (the ENTERPRISE data contract
that ``copy_array`` and the pickles round-trip), the same injectors and the
``signal_model`` provenance dict. Draw for draw with the JAX facade in its
default float32 mode, and with ``dtype=torch.float64`` draw for draw with
the JAX facade under ``jax_enable_x64`` (the port has no global float mode:
a pulsar's dtype is its own, and the array helpers take their pulsars'):

- every stochastic draw goes through explicit threefry keys (``seed=``, or
  the pulsar's own :class:`~fakepta_tpu_torch.utils.rng.KeyStream`), with
  the JAX facade's labels, counters and draw shapes: GP coefficients are
  drawn at ``(2, bucket_size(nbin, 8))`` against a zero-padded PSD, white
  noise at ``(ntoa,)``, ECORR from ``split(fold_in(key, 0x0E))``;
- host configuration draws (backends, frequency jitter, every draw of
  ``make_fake_array`` and ``copy_array``) come from numpy generators seeded
  with a key's two words, so they are bit-equal;
- phases are host float64 (``np.outer(toas, f) % 1``; absolute TOAs in
  seconds do not fit float32) and go to the device at the pulsar's dtype
  per injection; residuals, draws, named PSDs and projections are at the
  pulsar's dtype (float32 by default, or float64) on the device;
- CGW waveforms are evaluated at float64 on the CPU, whatever the device
  and dtype; pickles store float64 residuals.

Device rule: ``Pulsar``, ``make_fake_array`` and ``copy_array`` take
``device`` (``None`` is ``"cuda"``, which raises without a GPU; pass
``device="cpu"`` for the CPU) and ``dtype`` (``torch.float32`` or
``torch.float64``; ``copy_array`` defaults to its sources'). Residuals stay
on the device between injections; reading ``.residuals`` gives a writable
host array. Host state stays numpy, so a pickle holds no tensor; an
unpickled pulsar injects on the default device (or ``load_array``'s) at
the dtype it was built at.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import constants as const
from . import spectrum as spectrum_lib
from .device import DeviceLike, resolve_device
from .models import cgw as cgw_model
from .ops import fourier as fourier_ops
from .ops import white as white_ops
from .ops import woodbury as woodbury_ops
from .utils import rng as rng_utils
from .utils.masks import bucket_size

DAY_SECONDS = 86400.0
F32 = torch.float32


def _check_dtype(dtype) -> torch.dtype:
    """``dtype`` if the facade runs at it (the draws' dtypes: the JAX
    facade's float32 default and its x64 mode), else ``TypeError``."""
    if dtype not in rng_utils.DTYPES:
        raise TypeError(f"the facade runs at float32 or float64, not "
                        f"{dtype}")
    return dtype


def _dev(x, device, dtype) -> torch.Tensor:
    """``x`` (host array, number or tensor) as a ``dtype`` tensor on
    ``device``; host arrays are copied (they may be read-only)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(x, dtype=dtype, device=device)


def _host_tree(obj):
    """Tensors (nested in dicts) as host numpy: the pickle contract."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _host_tree(v) for k, v in obj.items()}
    return obj


def _gp_draw(key, phase, scale, psd, df, nbin: int, device, dtype):
    """(delta (..., ntoa), stored coefficients (..., 2, nbin)) of a fresh GP
    draw at ``dtype``: ``c ~ N(0, sqrt(psd))`` drawn at the bucketed bin
    count (the key consumption of the JAX facade), projected on the cos/sin
    basis of the host phase table."""
    psd = _dev(psd, device, dtype)
    psd_pad = torch.nn.functional.pad(psd, (0, bucket_size(nbin, 8) - nbin))
    coeffs = fourier_ops.draw_coeffs(key, psd_pad)[..., :nbin]
    df = _dev(df, device, dtype)
    basis = fourier_ops.basis_from_phase(_dev(phase, device, dtype),
                                         _dev(scale, device, dtype))
    delta = fourier_ops.inject_from_coeffs(basis, coeffs, df)
    return delta, coeffs / torch.sqrt(df)


def _gp_realization(phase, scale, fourier, df, device,
                    dtype) -> torch.Tensor:
    """The time-domain realization at ``dtype`` of stored coefficients on a
    host table."""
    basis = fourier_ops.basis_from_phase(_dev(phase, device, dtype),
                                         _dev(scale, device, dtype))
    return fourier_ops.reconstruct_from_fourier(
        basis, _dev(fourier, device, dtype), _dev(df, device, dtype))


def _batch_keys(psrs, label, seed, device) -> torch.Tensor:
    """(G, 2) keys of an array-level draw on ``device``: with ``seed=None``
    each pulsar's own next key (what a per-pulsar loop would use), else
    ``fold_in(key(seed), g)`` for pulsar ``g``."""
    if seed is None:
        keys = [p._keys.next(label) for p in psrs]
    else:
        base = rng_utils.as_key(seed).cpu()
        keys = [rng_utils.fold(base, g) for g in range(len(psrs))]
    return torch.stack(keys).to(device)


def _stack_current(psrs, device, dtype) -> torch.Tensor:
    """(G, T) current residuals at ``dtype`` on ``device``: one upload when
    every pulsar's are on the host, else one stack of the device rows."""
    if all(p._res_dev is None for p in psrs):
        return _dev(np.stack([p._res_host for p in psrs]), device, dtype)
    return torch.stack([p._res_current() for p in psrs])


def _batchable_olds(psrs, name):
    """Stored ``name`` entries if uniformly batchable for re-injection:
    ``[]`` when no pulsar has one (fresh injection), the entries when all
    do with one (f, idx, freqf, fourier shape), ``None`` when the state is
    mixed or holds joint-covariance entries (the caller falls back to the
    per-pulsar path)."""
    olds = [p.signal_model.get(name) for p in psrs]
    if any(o is not None and "fourier" not in o for o in olds):
        return None
    has = [o is not None for o in olds]
    if not any(has):
        return []
    if not all(has):
        return None
    o0 = olds[0]
    f0 = np.asarray(o0["f"], dtype=np.float64)
    if all(np.array_equal(np.asarray(o["f"], dtype=np.float64), f0)
           and o["idx"] == o0["idx"]
           and o.get("freqf", 1400.0) == o0.get("freqf", 1400.0)
           and np.shape(o["fourier"]) == np.shape(o0["fourier"])
           for o in olds):
        return olds
    return None


def _one_place(psrs):
    """The (device, dtype) every pulsar of ``psrs`` injects at, or None when
    they differ (the array helpers then loop the pulsars)."""
    places = {(p._dev(), p._dtype) for p in psrs}
    return places.pop() if len(places) == 1 else None


class Pulsar:
    """A fabricated pulsar: TOAs, timing model, noise bookkeeping, injected
    signals.

    ``toas`` are epoch times in seconds, repeated once per backend. ``seed``
    makes every stochastic method reproducible; omit it to draw from the
    package default seed stream. ``device``: where the residuals live and
    the injections run (``None`` is ``"cuda"``); ``dtype``: the residuals'
    and the draws' (``torch.float32``, or ``torch.float64`` for the JAX
    facade's x64 mode; anything else raises ``TypeError``).
    """

    #: the residuals' and draws' dtype: this class default, or the
    #: instance's own when it was built at float64 (the instance attribute
    #: set, and so the pickled one, stays the JAX facade's for the default)
    _dtype = F32

    def __init__(self, toas, toaerr, theta, phi, pdist=(1.0, 0.2),
                 freqs=(1400,), custom_noisedict=None, custom_model=None,
                 tm_params=None, backends=("backend",), ephem=None,
                 seed=None, device: DeviceLike = None,
                 dtype: torch.dtype = F32):
        if _check_dtype(dtype) != F32:
            self._dtype = dtype
        self._device = resolve_device(device)
        backends = list(backends)
        self._keys = rng_utils.KeyStream(seed)
        host_rng = self._keys.host_rng("init")

        self.nepochs = len(toas)
        self.toas = np.repeat(np.asarray(toas, dtype=np.float64),
                              len(backends))
        self.toaerrs = float(toaerr) * np.ones(len(self.toas))
        self.residuals = np.zeros(len(self.toas))
        self.Tspan = float(self.toas.max() - self.toas.min())
        self.custom_model = dict(custom_model) if custom_model is not None \
            else {"RN": 30, "DM": 100, "Sv": None}
        self.signal_model: Dict[str, dict] = {}
        self._waveforms: Dict[str, callable] = {}
        self.flags = {"pta": ["FAKE"] * len(self.toas)}
        self.freqs, self.backend_flags = self.get_freqs_and_backends(
            list(freqs), backends, host_rng)
        self.backends = np.unique(self.backend_flags)
        # observing-frequency jitter ~ N(0, 10 MHz), as the reference has
        self.freqs = np.abs(self.freqs + host_rng.normal(
            scale=10.0, size=len(self.freqs)))
        self.theta = theta
        self.phi = phi
        self.pos = np.array([np.cos(phi) * np.sin(theta),
                             np.sin(phi) * np.sin(theta),
                             np.cos(theta)])
        self.ephem = ephem
        if ephem is not None:
            self.planetssb = ephem.get_planet_ssb(self.toas)
            self.pos_t = np.tile(self.pos, (len(self.toas), 1))
        else:
            self.planetssb = None
            self.pos_t = None
        self.pdist = pdist
        self.name = self.get_psrname()
        self.init_tm_pars(tm_params)
        self.make_Mmat()
        self.fitpars = list(self.tm_pars)
        self.init_noisedict(custom_noisedict)

    # ------------------------------------------------------------------
    # residual storage: on the device between injections
    # ------------------------------------------------------------------
    #
    # Exactly one of two slots is authoritative: a tensor at the pulsar's
    # dtype on the device (after an injection) or a host array (after
    # construction, a read or an assignment). Reading drops the device copy,
    # so in-place numpy mutation of the returned array stays correct.

    def _dev(self) -> torch.device:
        """The injection device; an unpickled pulsar resolves the default
        (``"cuda"``) at its next injection."""
        if self.__dict__.get("_device") is None:
            self._device = resolve_device(None)
        return self._device

    @property
    def residuals(self) -> np.ndarray:
        """Timing residuals in seconds, as a writable host array (at the
        pulsar's dtype once an injection ran on the device; pickles store
        float64)."""
        if self._res_host is None:
            t = self._res_dev.detach()
            host = t.cpu().numpy()
            # a CPU tensor may be a row of an array block: copy it out
            self._res_host = host.copy() if t.device.type == "cpu" else host
            self._res_dev = None
        return self._res_host

    @residuals.setter
    def residuals(self, value):
        if isinstance(value, torch.Tensor):
            self._res_dev = value
            self._res_host = None
        else:
            self._res_host = np.asarray(value)
            self._res_dev = None

    def _res_current(self) -> torch.Tensor:
        """The residuals as a tensor at the pulsar's dtype on the injection
        device."""
        if self._res_dev is not None:
            return self._res_dev
        return _dev(self._res_host, self._dev(), self._dtype)

    def _accumulate(self, delta):
        """residuals += delta, on the injection device."""
        cur = self._res_current()
        self.residuals = cur + _dev(delta, cur.device, cur.dtype)

    def _next_key(self, seed, label) -> torch.Tensor:
        """This draw's key: the pulsar's next stream key, or ``seed``'s."""
        if seed is None:
            return self._keys.next(label)
        return rng_utils.as_key(seed)

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    def get_freqs_and_backends(self, freqs, backends, host_rng=None):
        """Tile backend names across epochs and resolve observing
        frequencies: a backend named ``'NAME.1440'`` pins its frequency from
        the suffix; otherwise a random frequency from ``freqs`` is chosen
        and appended to the backend name."""
        host_rng = host_rng or self._keys.host_rng("freqs_backends")
        flags = np.tile(np.asarray(backends, dtype=object), self.nepochs)
        b_freqs = np.empty(len(flags))
        for i, flag in enumerate(flags):
            suffix = str(flag).rsplit(".", 1)[-1]
            try:
                b_freqs[i] = float(suffix)
            except ValueError:
                choice = host_rng.choice(freqs)
                flags[i] = f"{flag}.{int(choice)}"
                b_freqs[i] = choice
        return b_freqs, flags.astype(str)

    def init_noisedict(self, custom_noisedict=None):
        """Resolve white-noise parameters into ``self.noisedict``.

        Four-way resolution with the reference's precedence: (a) no dict ->
        per-backend defaults; (b) keys mentioning this pulsar's name ->
        filtered through; (c) per-backend keys ``<backend>_efac`` ->
        prefixed with the pulsar name; (d) global keys ``efac`` /
        ``log10_tnequad`` / ... applied to every backend. Red / DM /
        chromatic hyper-parameters pass through, pulsar-prefixed or bare.
        """
        nd = {}
        src = custom_noisedict or {}
        if custom_noisedict is None:
            for backend in self.backends:
                nd[f"{self.name}_{backend}_efac"] = 1.0
                nd[f"{self.name}_{backend}_log10_tnequad"] = -8.0
                nd[f"{self.name}_{backend}_log10_t2equad"] = -8.0
                nd[f"{self.name}_{backend}_log10_ecorr"] = -8.0
        elif any(self.name in key for key in src):
            nd.update({key: val for key, val in src.items()
                       if self.name in key})
        elif all(f"{backend}_efac" in src for backend in self.backends):
            for backend in self.backends:
                nd[f"{self.name}_{backend}_efac"] = src[f"{backend}_efac"]
                nd[f"{self.name}_{backend}_log10_tnequad"] = \
                    src[f"{backend}_log10_tnequad"]
                for opt in ("log10_t2equad", "log10_ecorr"):
                    if f"{backend}_{opt}" in src:
                        nd[f"{self.name}_{backend}_{opt}"] = \
                            src[f"{backend}_{opt}"]
        else:
            for backend in self.backends:
                nd[f"{self.name}_{backend}_efac"] = src["efac"]
                nd[f"{self.name}_{backend}_log10_tnequad"] = \
                    src["log10_tnequad"]
                for opt in ("log10_t2equad", "log10_ecorr"):
                    if opt in src:
                        nd[f"{self.name}_{backend}_{opt}"] = src[opt]
        for gp in ("red_noise", "dm_gp", "chrom_gp"):
            if any(gp in key for key in src):
                for par in ("log10_A", "gamma"):
                    prefixed = f"{self.name}_{gp}_{par}"
                    bare = f"{gp}_{par}"
                    if prefixed in src:
                        nd[prefixed] = src[prefixed]
                    elif bare in src:
                        nd[prefixed] = src[bare]
        self.noisedict = nd

    def init_tm_pars(self, timing_model=None):
        """Default timing-model ``(value, uncertainty)`` pairs."""
        self.tm_pars = {
            "F0": (200, 1e-13),
            "F1": (0.0, 1e-20),
            "DM": (0.0, 5e-4),
            "DM1": (0.0, 1e-4),
            "DM2": (0.0, 1e-5),
            "ELONG": (0.0, 1e-5),
            "ELAT": (0.0, 1e-5),
        }
        if timing_model is not None:
            self.tm_pars.update(timing_model)

    def make_Mmat(self, t0=0.0):
        """Timing-model design matrix: offset; spin terms scaled by 1/F0;
        DM, DM1, DM2 columns in 1/nu^2; annual cos/sin. ``npar =
        len(tm_pars) + 1``, so extra user timing parameters give zero
        columns (the reference's shape)."""
        t = self.toas - t0
        f0 = self.tm_pars["F0"][0]
        npar = len(self.tm_pars) + 1
        m = np.zeros((len(self.toas), npar))
        m[:, 0] = 1.0
        m[:, 1] = -t / f0
        m[:, 2] = -0.5 * t**2 / f0
        m[:, 3] = 1.0 / self.freqs**2
        m[:, 4] = t / self.freqs**2 / f0
        m[:, 5] = 0.5 * t**2 / self.freqs**2 / f0
        omega_yr = 2.0 * np.pi / const.yr
        m[:, 6] = np.cos(omega_yr * t)
        m[:, 7] = np.sin(omega_yr * t)
        self.Mmat = m

    # ------------------------------------------------------------------
    # state management
    # ------------------------------------------------------------------

    def update_position(self, theta, phi, update_name=False):
        """Recompute the sky unit vector (and optionally the name)."""
        self.theta = theta
        self.phi = phi
        self.pos = np.array([np.cos(phi) * np.sin(theta),
                             np.sin(phi) * np.sin(theta),
                             np.cos(theta)])
        if update_name:
            self.name = self.get_psrname()

    def update_noisedict(self, prefix, dict_vals):
        """Prefix-merge hyper-parameters into the noisedict."""
        self.noisedict.update({f"{prefix}_{key}": val
                               for key, val in dict_vals.items()})

    @staticmethod
    def _noisedict_fragment(signal):
        """Substring that identifies a signal's hyper-parameters in the
        noisedict (stored system-noise keys carry a backend prefix the
        noisedict keys do not)."""
        if "system_noise" in signal:
            return "system_noise_" + signal.split("system_noise_")[1]
        return signal

    def make_ideal(self):
        """Zero the residuals and forget every injected signal."""
        self.residuals = np.zeros(len(self.toas))
        for signal in list(self.signal_model):
            self.signal_model.pop(signal)
            frag = self._noisedict_fragment(signal)
            for key in list(self.noisedict):
                if frag in key:
                    self.noisedict.pop(key)
        self._waveforms.clear()

    # ------------------------------------------------------------------
    # host phase tables
    # ------------------------------------------------------------------

    def _phase_scale(self, f_psd, idx, freqf=1400.0, mask=None):
        """Host float64 (phase (ntoa, nbin), scale (ntoa,), df (nbin,)).

        Phases are fractional cycles ``np.outer(toas, f) % 1`` times 2 pi,
        exact at 1e9 s TOAs. Memoized per pulsar under a key of every input
        the table depends on, bounded at 8 MiB of tables (oldest evicted
        first).
        """
        f_psd = np.asarray(f_psd, dtype=np.float64)
        cache_key = (self.toas.tobytes(), f_psd.tobytes(), float(idx),
                     float(freqf),
                     self.freqs.tobytes() if idx else None,
                     mask.tobytes() if mask is not None else None)
        cache = self.__dict__.setdefault("_phase_cache", {})
        hit = cache.get(cache_key)
        if hit is not None:
            return hit
        toas = self.toas if mask is None else self.toas[mask]
        nu = self.freqs if mask is None else self.freqs[mask]
        phase = 2.0 * np.pi * (np.outer(toas, f_psd) % 1.0)
        scale = (freqf / nu) ** idx
        df = np.diff(np.concatenate([[0.0], f_psd]))
        out = (phase, scale, df)
        entry_bytes = phase.nbytes + scale.nbytes + df.nbytes
        self._phase_cache_bytes = self.__dict__.get("_phase_cache_bytes", 0)
        while cache and self._phase_cache_bytes + entry_bytes > 8 << 20:
            old = cache.pop(next(iter(cache)))
            self._phase_cache_bytes -= sum(a.nbytes for a in old)
        cache[cache_key] = out
        self._phase_cache_bytes += entry_bytes
        return out

    # ------------------------------------------------------------------
    # stochastic injectors
    # ------------------------------------------------------------------

    def add_white_noise(self, add_ecorr=False, randomize=False, seed=None):
        """Inject EFAC/EQUAD (and optional epoch-correlated ECORR) white
        noise, with the ENTERPRISE block variance ``10^(2 log10_ecorr)``;
        ``randomize`` redraws the white-noise dictionary entries uniformly
        first, as the reference does."""
        key = self._next_key(seed, "white")
        efac, equad, ecorr = self._white_params(randomize, add_ecorr)
        cur = self._res_current()
        dev, dtype = cur.device, self._dtype
        par = _dev(np.stack([self.toaerrs, efac, equad]), dev, dtype)
        sigma2 = white_ops.white_sigma2(par[0], par[1], par[2])
        if add_ecorr:
            epoch_idx, n_epochs, counts = self._epoch_segments()
            delta = white_ops.draw_white_ecorr(
                key, sigma2, _dev(10.0 ** (2.0 * ecorr), dev, dtype),
                torch.as_tensor(epoch_idx, device=dev), n_epochs,
                _dev(counts >= 2, dev, dtype))
        else:
            delta = white_ops.draw_white(key, sigma2)
        self.residuals = cur + delta

    def _white_params(self, randomize=False, add_ecorr=False):
        """(efac, equad, log10_ecorr) per-TOA arrays from the noisedict;
        ``randomize`` redraws the entries from this pulsar's host stream
        first."""
        if randomize:
            host = self._keys.host_rng("white_randomize")
            for k in self.noisedict:
                if "efac" in k:
                    self.noisedict[k] = host.uniform(0.5, 2.5)
                if "equad" in k:
                    self.noisedict[k] = host.uniform(-8.0, -5.0)
                if add_ecorr and "ecorr" in k:
                    self.noisedict[k] = host.uniform(-10.0, -7.0)
        efac = np.empty(len(self.toas))
        equad = np.empty(len(self.toas))
        ecorr = np.full(len(self.toas), -np.inf)
        for backend in self.backends:
            sel = self.backend_flags == backend
            efac[sel] = self.noisedict[f"{self.name}_{backend}_efac"]
            equad[sel] = self.noisedict[f"{self.name}_{backend}_log10_tnequad"]
            if add_ecorr:
                ecorr[sel] = self.noisedict[
                    f"{self.name}_{backend}_log10_ecorr"]
        return efac, equad, ecorr

    def _epoch_segments(self, dt=1.0, backends=None):
        """(epoch id per TOA, n_epochs, counts): what the ECORR sampler
        consumes; every backend's final group is kept."""
        if backends is None:
            codes = self.backend_flags
        else:
            sel = np.isin(self.backend_flags, backends)
            codes = np.where(sel, self.backend_flags, "__excluded__")
        return white_ops.quantise_epochs(self.toas - self.toas[0], codes,
                                         dt=dt * DAY_SECONDS)

    def quantise_ecorr(self, dt=1.0, backends=None):
        """Per-backend epoch index groups (a list of arrays), every epoch
        included; with ``backends`` only those backends' TOAs."""
        epoch_idx, n_epochs, _ = self._epoch_segments(dt=dt,
                                                      backends=backends)
        keep = np.ones(len(self.toas), dtype=bool) if backends is None \
            else np.isin(self.backend_flags, backends)
        groups = []
        for ep in range(n_epochs):
            sel = np.flatnonzero((epoch_idx == ep) & keep)
            if len(sel):
                groups.append(sel)
        return groups

    def _resolve_psd(self, signal, spectrum, f_psd, kwargs):
        """(psd, resolved kwargs) of a GP injection. Named spectra evaluate
        on the CPU at the pulsar's dtype (the JAX facade's precision in its
        float32 or x64 mode) from the kwargs or the noisedict."""
        if spectrum == "custom":
            custom = kwargs["custom_psd"]
            if isinstance(custom, torch.Tensor):
                return custom, {}
            return np.asarray(custom, dtype=np.float64), {}
        if spectrum not in spectrum_lib.SPECTRA:
            raise KeyError(f"unknown spectrum {spectrum!r}")
        if not kwargs:
            try:
                kwargs = {p: self.noisedict[f"{self.name}_{signal}_{p}"]
                          for p in spectrum_lib.spec_params[spectrum]}
            except KeyError as exc:
                raise ValueError(
                    f"PSD parameters for {signal} must be in the noisedict "
                    f"or passed as keyword arguments (missing {exc})"
                ) from exc
        psd = spectrum_lib.evaluate_host_at(spectrum, f_psd, self._dtype,
                                            **kwargs)
        return psd, kwargs

    def add_red_noise(self, spectrum="powerlaw", f_psd=None, seed=None,
                      **kwargs):
        """Achromatic red noise with ``custom_model['RN']`` Fourier bins;
        re-injection replaces the prior realization."""
        self._add_gp_signal("red_noise", "RN", spectrum, f_psd, 0.0, seed,
                            kwargs)

    def add_dm_noise(self, spectrum="powerlaw", f_psd=None, seed=None,
                     **kwargs):
        """Dispersion-measure noise (chromatic index 2)."""
        self._add_gp_signal("dm_gp", "DM", spectrum, f_psd, 2.0, seed, kwargs)

    def add_chromatic_noise(self, spectrum="powerlaw", f_psd=None, seed=None,
                            **kwargs):
        """Scattering-variation noise (chromatic index 4)."""
        self._add_gp_signal("chrom_gp", "Sv", spectrum, f_psd, 4.0, seed,
                            kwargs)

    def _add_gp_signal(self, signal, model_key, spectrum, f_psd, idx, seed,
                       kwargs):
        components = self.custom_model.get(model_key)
        if components is None:
            return
        if f_psd is None:
            f_psd = np.arange(1, components + 1) / self.Tspan
        f_psd = np.asarray(f_psd, dtype=np.float64)
        # resolve and validate before mutating state, so a failed call
        # cannot leave the old realization half-subtracted
        psd, resolved = self._resolve_psd(signal, spectrum, f_psd, kwargs)
        if len(psd) != len(f_psd):
            raise ValueError('"psd" and "f_psd" must have the same length')
        if resolved:
            self.update_noisedict(f"{self.name}_{signal}", resolved)
        self.add_time_correlated_noise(
            signal=signal, spectrum=spectrum, psd=psd, f_psd=f_psd, idx=idx,
            seed=seed, _subtract=self.signal_model.get(signal))

    def add_system_noise(self, backend=None, components=30,
                         spectrum="powerlaw", f_psd=None, seed=None,
                         **kwargs):
        """Per-backend system noise. The stored signal key is
        ``'<backend>_system_noise_<backend>'`` (the reference's composite),
        because downstream consumers split on ``'system_noise_'`` to
        recover the backend name."""
        if backend is None:
            raise ValueError('system noise requires a "backend" name')
        signal = f"system_noise_{backend}"
        if f_psd is None:
            f_psd = np.arange(1, components + 1) / self.Tspan
        f_psd = np.asarray(f_psd, dtype=np.float64)
        stored = f"{backend}_{signal}"
        psd, resolved = self._resolve_psd(signal, spectrum, f_psd, kwargs)
        if len(psd) != len(f_psd):
            raise ValueError('"psd" and "f_psd" must have the same length')
        if resolved:
            self.update_noisedict(f"{self.name}_{signal}", resolved)
        self.add_time_correlated_noise(
            signal=signal, spectrum=spectrum, psd=psd, f_psd=f_psd, idx=0.0,
            backend=backend, seed=seed,
            _subtract=self.signal_model.get(stored))

    def add_time_correlated_noise(self, signal="", spectrum="powerlaw",
                                  psd=None, f_psd=None, idx=0, freqf=1400,
                                  backend=None, seed=None, _subtract=None):
        """Core Fourier-basis GP injector.

        Draws ``c ~ N(0, sqrt(psd))``, adds ``(freqf/nu)^idx sqrt(df)
        (c_cos cos + c_sin sin)`` to the residuals (of ``backend``'s TOAs
        only, when given) and records the ``signal_model`` entry, whose
        stored coefficients are ``c/sqrt(df)`` (host, at the pulsar's
        dtype).
        ``_subtract`` (internal): a stored entry whose realization is
        subtracted in the same update (re-injection).
        """
        key = self._next_key(seed, signal or "gp")
        if backend is not None:
            signal = f"{backend}_{signal}"
            mask = self.backend_flags == backend
            if not mask.any():
                raise ValueError(f"{backend!r} not found in backend_flags")
        else:
            mask = None
        f_psd = np.asarray(f_psd, dtype=np.float64)
        if not isinstance(psd, torch.Tensor):
            psd = np.asarray(psd, dtype=np.float64)
        if len(psd) != len(f_psd):
            raise ValueError('"psd" and "f_psd" must have the same length')

        phase, scale, df = self._phase_scale(f_psd, idx, freqf, mask)
        if _subtract is not None and "fourier" not in _subtract:
            # joint-covariance entries store the realization itself
            self._accumulate(-_dev(_subtract["realization"], self._dev(),
                                   self._dtype))
            _subtract = None
        cur = self._res_current()
        delta, fourier = _gp_draw(key, phase, scale, psd, df, len(f_psd),
                                  cur.device, self._dtype)
        if _subtract is not None:
            old = self._phase_scale(
                np.asarray(_subtract["f"], dtype=np.float64),
                _subtract["idx"], _subtract.get("freqf", 1400.0), mask)
            delta = delta - _gp_realization(old[0], old[1],
                                            _subtract["fourier"], old[2],
                                            cur.device, self._dtype)
        if mask is None:
            self.residuals = cur + delta
        else:
            self.residuals = cur.index_add(
                0, torch.as_tensor(np.flatnonzero(mask), device=cur.device),
                delta)
        self.signal_model[signal] = {
            "spectrum": spectrum,
            "f": f_psd,
            "psd": psd,
            "fourier": fourier.cpu().numpy(),
            "nbin": len(f_psd),
            "idx": idx,
            "freqf": freqf,
        }

    # ------------------------------------------------------------------
    # deterministic injectors
    # ------------------------------------------------------------------

    def add_cgw(self, costheta, phi, cosinc, log10_mc, log10_fgw, log10_h,
                phase0, psi, psrterm=False):
        """Inject a circular-SMBHB continuous wave (full frequency
        evolution), appended under ``signal_model['cgw']``."""
        record = {"costheta": costheta, "phi": phi, "cosinc": cosinc,
                  "log10_mc": log10_mc, "log10_fgw": log10_fgw,
                  "log10_h": log10_h, "phase0": phase0, "psi": psi,
                  "psrterm": psrterm}
        slot = self.signal_model.setdefault("cgw", {})
        slot[str(len(slot))] = record
        self._accumulate(self._cw_delay_host64(record))

    def _cw_delay_host64(self, rec) -> np.ndarray:
        """One CGW waveform at float64 on the CPU, whatever the device:
        absolute epochs (~4.6e9 s) quantize at ~550 s in float32."""
        kw = dict(cos_gwtheta=rec["costheta"], gwphi=rec["phi"],
                  cos_inc=rec["cosinc"], log10_mc=rec["log10_mc"],
                  log10_fgw=rec["log10_fgw"], log10_h=rec["log10_h"],
                  phase0=rec["phase0"], psi=rec["psi"],
                  psrTerm=rec["psrterm"], evolve=True)
        toas = torch.as_tensor(np.asarray(self.toas, dtype=np.float64))
        pos = torch.as_tensor(np.asarray(self.pos, dtype=np.float64))
        return cgw_model.cw_delay(toas, pos, self.pdist, **kw).numpy()

    def add_deterministic(self, waveform, **kwargs):
        """Inject any user waveform ``waveform(toas=..., **kwargs)``; the
        callable is remembered so the signal can be reconstructed and
        removed."""
        fname = waveform.__name__
        slot = self.signal_model.setdefault(fname, {})
        slot[str(len(slot))] = dict(kwargs)
        self._waveforms[fname] = waveform
        self._accumulate(waveform(toas=self.toas, **kwargs))

    # ------------------------------------------------------------------
    # coordinates and naming
    # ------------------------------------------------------------------

    @staticmethod
    def radec_to_thetaphi(ra, dec):
        """(RA [h, m], dec [deg, arcmin]) -> (theta, phi)."""
        theta = np.pi / 2 - np.pi / 180 * (dec[0] + dec[1] / 60)
        phi = 2 * np.pi * (ra[0] + ra[1] / 60) / 24
        return theta, phi

    @staticmethod
    def thetaphi_to_radec(theta, phi):
        """(theta, phi) -> (RA [h, m], dec [deg, arcmin]), the inverse of
        :meth:`radec_to_thetaphi`."""
        dec_deg = (np.pi / 2 - theta) * 180 / np.pi
        dec = [int(np.floor(dec_deg)), int((dec_deg - np.floor(dec_deg)) * 60)]
        ra_h = phi * 24 / (2 * np.pi)
        ra = [int(np.floor(ra_h)), int((ra_h - np.floor(ra_h)) * 60)]
        return ra, dec

    def get_psrname(self):
        """J-name from the sky position, e.g. ``J1234+0456``, formatted as
        the reference does (generated names key the noisedict)."""
        ra_hours = 24 * self.phi / (2 * np.pi)
        h = int(ra_hours)
        m = int((ra_hours - h) * 60)
        dec = round(180 * (np.pi / 2 - self.theta) / np.pi, 2)
        sign = "+" if dec >= 0 else "-"
        decl, _, decr = f"{abs(dec)}".partition(".")
        return f"J{h:02d}{m:02d}{sign}{int(decl):02d}{int(decr or 0):02d}"

    # ------------------------------------------------------------------
    # covariances, sampling, reconstruction
    # ------------------------------------------------------------------

    def make_time_correlated_noise_cov(self, signal="", freqf=None):
        """Dense covariance (at the pulsar's dtype) of one stored GP signal;
        ``freqf=None`` uses the signal's stored reference frequency."""
        if "system_noise" in signal:
            backend = signal.split("system_noise_")[1]
            stored = f"{backend}_system_noise_{backend}" \
                if not signal.startswith(f"{backend}_") else signal
            mask = self.backend_flags == backend
            if not mask.any():
                raise ValueError(f"{backend!r} not found in backend_flags")
        else:
            stored, mask = signal, None
        entry = self.signal_model[stored]
        if freqf is None:
            freqf = entry.get("freqf", 1400.0)
        phase, scale, df = self._phase_scale(
            np.asarray(entry["f"], dtype=np.float64), entry["idx"], freqf,
            mask)
        dev, dtype = self._dev(), self._dtype
        basis = fourier_ops.basis_from_phase(_dev(phase, dev, dtype),
                                             _dev(scale, dev, dtype))
        return fourier_ops.gp_covariance(
            basis, _dev(entry["psd"], dev, dtype),
            _dev(df, dev, dtype)).cpu().numpy()

    def make_noise_covariance_matrix(self):
        """(white variance vector, dense red covariance): the red part sums
        the RN/DM/Sv covariances of signals both enabled in
        ``custom_model`` and injected."""
        efac = np.empty(len(self.toas))
        equad = np.empty(len(self.toas))
        for backend in self.backends:
            sel = self.backend_flags == backend
            efac[sel] = self.noisedict[f"{self.name}_{backend}_efac"]
            equad[sel] = self.noisedict[f"{self.name}_{backend}_log10_tnequad"]
        par = torch.as_tensor(np.stack([self.toaerrs, efac, equad]),
                              dtype=self._dtype)
        white_cov = white_ops.white_sigma2(par[0], par[1], par[2]).numpy()
        red_cov = np.zeros((len(self.toas), len(self.toas)))
        for model_key, signal in (("RN", "red_noise"), ("DM", "dm_gp"),
                                  ("Sv", "chrom_gp")):
            if self.custom_model.get(model_key) is not None \
                    and signal in self.signal_model:
                red_cov += self.make_time_correlated_noise_cov(signal)
        return white_cov, red_cov

    def draw_noise_model(self, residuals=None, seed=None):
        """A draw at the pulsar's dtype from the total noise covariance
        (Cholesky of ``cov + 1e-24 I``), or with ``residuals`` the Wiener
        estimate ``red^T cov^-1 r`` of the red process. A covariance that is
        not positive definite at that dtype gives NaN, as in the JAX
        facade."""
        white_cov, red_cov = self.make_noise_covariance_matrix()
        dev, dtype = self._dev(), self._dtype
        cov = _dev(np.diag(white_cov) + red_cov, dev, dtype)
        if residuals is None:
            key = self._keys.next("noise_model") if seed is None \
                else rng_utils.as_key(seed)
            n = cov.shape[0]
            chol, info = torch.linalg.cholesky_ex(
                cov + 1e-24 * torch.eye(n, dtype=dtype, device=dev))
            chol = torch.where(info == 0, chol,
                               torch.full_like(chol, math.nan))
            return (chol @ rng_utils.normal(key.to(dev), n, dtype=dtype)
                    ).cpu().numpy()
        red = _dev(red_cov, dev, dtype)
        return (red.T @ woodbury_ops.cho_solve_psd(
            cov, _dev(np.asarray(residuals), dev, dtype))).cpu().numpy()

    def reconstruct_signal(self, signals=None, freqf=None):
        """The time-domain realization of stored signals (GP, system noise,
        every CGW, recorded waveforms), as a writable host array.
        ``freqf=None`` uses each signal's stored reference frequency; a
        value overrides it for every signal. A bare name is one signal."""
        if signals is None:
            signals = list(self.signal_model)
        elif isinstance(signals, str):
            signals = [signals]
        return self._reconstruct_signal_dev(signals, freqf).cpu().numpy()

    def _reconstruct_signal_dev(self, signals, freqf=None) -> torch.Tensor:
        dev, dtype = self._dev(), self._dtype
        sig = torch.zeros(len(self.toas), dtype=dtype, device=dev)
        for signal in signals:
            if signal == "cgw":
                # the same host-f64 evaluation as add_cgw, so remove_signal
                # subtracts exactly what was injected
                for record in self.signal_model.get("cgw", {}).values():
                    sig = sig + _dev(self._cw_delay_host64(record), dev,
                                     dtype)
            elif signal in self._waveforms:
                for record in self.signal_model[signal].values():
                    sig = sig + _dev(
                        self._waveforms[signal](toas=self.toas, **record),
                        dev, dtype)
            elif "system_noise" in signal:
                backend = signal.split("system_noise_")[1]
                mask = self.backend_flags == backend
                sig = sig.index_add(
                    0, torch.as_tensor(np.flatnonzero(mask), device=dev),
                    self._reconstruct_gp(self.signal_model[signal], freqf,
                                         mask))
            elif signal in self.signal_model \
                    and "fourier" in self.signal_model[signal]:
                sig = sig + self._reconstruct_gp(self.signal_model[signal],
                                                 freqf, None)
            elif signal in self.signal_model \
                    and "realization" in self.signal_model[signal]:
                # joint-covariance common signals store the draw itself
                sig = sig + _dev(self.signal_model[signal]["realization"],
                                 dev, dtype)
        return sig

    def _reconstruct_gp(self, entry, freqf, mask) -> torch.Tensor:
        if freqf is None:
            freqf = entry.get("freqf", 1400.0)
        phase, scale, df = self._phase_scale(
            np.asarray(entry["f"], dtype=np.float64), entry["idx"], freqf,
            mask)
        return _gp_realization(phase, scale, entry["fourier"], df,
                               self._dev(), self._dtype)

    def remove_signal(self, signals=None, freqf=None):
        """Subtract stored signals' realizations and forget them."""
        if signals is None:
            signals = list(self.signal_model)
        elif isinstance(signals, str):
            signals = [signals]
        self._accumulate(-self._reconstruct_signal_dev(signals, freqf=freqf))
        for signal in signals:
            self.signal_model.pop(signal, None)
            self._waveforms.pop(signal, None)
            frag = self._noisedict_fragment(signal)
            for key in list(self.noisedict):
                if frag in key:
                    self.noisedict.pop(key)

    # pickling: host float64 residuals and host signal_model (the
    # ENTERPRISE contract); the key stream, waveform callables, phase
    # tables and device are not stored. A float64 pulsar keeps its dtype
    # (its instance attribute), so it injects at float64 after a reload;
    # at float32 the stored attributes are the JAX facade's
    def __getstate__(self):
        state = dict(self.__dict__)
        for k in ("_res_host", "_res_dev", "_phase_cache",
                  "_phase_cache_bytes", "_device"):
            state.pop(k, None)
        state["residuals"] = np.asarray(self.residuals, dtype=np.float64)
        state["signal_model"] = _host_tree(self.signal_model)
        state["_keys"] = None
        state["_waveforms"] = {}
        return state

    def __setstate__(self, state):
        residuals = state.pop("residuals")
        self.__dict__.update(state)
        self._device = None
        self.residuals = np.asarray(residuals)
        if self.__dict__.get("_keys") is None:
            self._keys = rng_utils.KeyStream(None)


# ---------------------------------------------------------------------------
# Array-level factories
# ---------------------------------------------------------------------------

def make_fake_array(npsrs=25, Tobs=None, ntoas=None, gaps=True, toaerr=None,
                    pdist=None, freqs=(1400,), isotropic=False, backends=None,
                    noisedict=None, custom_model=None, custom_models=None,
                    ephem=None, seed=None, device: DeviceLike = None,
                    dtype: torch.dtype = F32):
    """Fabricate a pulsar array with randomized observing configurations.

    Sky positions on a Fibonacci sphere when ``isotropic``, else uniform;
    per-pulsar spans, cadences (phase-locked to an integer pulse count of a
    drawn F0), TOA gaps (keep probability 3/4), TOA errors (log-uniform
    1e-7..1e-5 s), distances and 1-2 random backends follow the reference's
    distributions. Red / DM / chromatic power laws are injected from the
    noisedict when present, else with random (log10_A ~ U(-17, -13), gamma
    ~ U(1, 5)) hyper-parameters. ``seed`` drives every draw;
    ``custom_models`` maps pulsar names to custom_model dicts. ``device``
    and ``dtype``: every pulsar's (``None`` is ``"cuda"``; float32, or
    float64 for the JAX facade's x64 mode).
    """
    dtype = _check_dtype(dtype)
    dev = resolve_device(device)
    stream = rng_utils.KeyStream(seed, "make_fake_array")
    host = stream.host_rng("config")

    if isotropic:
        i = np.arange(npsrs, dtype=float) + 0.5
        golden = (1 + 5**0.5) / 2
        costhetas = 1 - 2 * i / npsrs
        phis = np.mod(2 * np.pi * i / golden, 2 * np.pi)
    else:
        costhetas = host.uniform(-1.0, 1.0, size=npsrs)
        phis = host.uniform(0.0, 2 * np.pi, size=npsrs)

    if Tobs is None:
        Tobs = host.uniform(10, 20, size=npsrs)
    elif np.isscalar(Tobs):
        Tobs = float(Tobs) * np.ones(npsrs)

    Tobs = np.asarray(Tobs, dtype=np.float64)
    if ntoas is None:
        base_cadence = 7 * DAY_SECONDS
        F0 = host.uniform(200, 300, size=npsrs)
        # phase-lock the cadence to an integer number of pulses
        cadence = base_cadence - (F0 * base_cadence
                                  - np.floor(F0 * base_cadence)) / F0
        ntoas = np.int32(Tobs * const.yr / cadence)
    else:
        F0 = 200 * np.ones(npsrs)
        if np.isscalar(ntoas):
            ntoas = np.int32(int(ntoas) * np.ones(npsrs))
        else:
            ntoas = np.asarray(ntoas, dtype=np.int32)
        cadence = Tobs * const.yr / (ntoas - 1)

    Tmax = np.max(Tobs)
    toas = []
    for i in range(npsrs):
        t = (Tmax - Tobs[i]) * const.yr + np.arange(1, ntoas[i] + 1) \
            * cadence[i]
        if gaps:
            keep = host.random(size=ntoas[i]) < 0.75
            t = t[keep]
        toas.append(t)

    if toaerr is None:
        toaerr = 10.0 ** host.uniform(-7.0, -5.0, size=npsrs)
    elif np.isscalar(toaerr):
        toaerr = float(toaerr) * np.ones(npsrs)

    if pdist is None:
        dists = host.uniform(0.5, 1.5, size=npsrs)
        pdist = [[d, 0.2 * d] for d in dists]
    elif np.isscalar(pdist):
        pdist = [[float(pdist), 0.2 * float(pdist)]] * npsrs

    if backends is None:
        backends = [[f"backend_{k}" for k in range(host.integers(1, 3))]
                    for _ in range(npsrs)]
    elif isinstance(backends, str):
        backends = [[backends]] * npsrs
    elif isinstance(backends, list) and not isinstance(backends[0], list):
        backends = [backends] * npsrs

    for nm, arr in (("Tobs", Tobs), ("ntoas", ntoas), ("toaerr", toaerr),
                    ("pdist", pdist), ("backends", backends)):
        if len(arr) != npsrs:
            raise ValueError(f'"{nm}" must be same size as "npsrs"')

    psrs = []
    for i in range(npsrs):
        psr = Pulsar(toas[i], toaerr[i], np.arccos(costhetas[i]), phis[i],
                     pdist[i], freqs=freqs, backends=backends[i],
                     custom_noisedict=noisedict, custom_model=custom_model,
                     tm_params={"F0": (F0[i], host.uniform(1e-13, 1e-12))},
                     ephem=ephem,
                     seed=int(stream.host_rng("psr", i).integers(2**31)),
                     device=dev, dtype=dtype)
        if custom_models is not None and psr.name in custom_models:
            cm = custom_models[psr.name]
            if cm is not None:
                psr.custom_model = dict(cm)
        psr.add_white_noise()
        for adder, gp in ((psr.add_red_noise, "red_noise"),
                          (psr.add_dm_noise, "dm_gp"),
                          (psr.add_chromatic_noise, "chrom_gp")):
            amp_key = f"{psr.name}_{gp}_log10_A"
            gam_key = f"{psr.name}_{gp}_gamma"
            if amp_key in psr.noisedict and gam_key in psr.noisedict:
                adder(spectrum="powerlaw", log10_A=psr.noisedict[amp_key],
                      gamma=psr.noisedict[gam_key])
            else:
                adder(spectrum="powerlaw",
                      log10_A=host.uniform(-17.0, -13.0),
                      gamma=host.uniform(1.0, 5.0))
        psrs.append(psr)
    return psrs


def add_white_noise_array(psrs, add_ecorr=False, randomize=False, seed=None):
    """Inject EFAC/EQUAD white noise across a whole array in one batched
    draw. With ``seed=None`` each pulsar consumes its own key stream (the
    draws of a per-pulsar loop); an explicit ``seed`` folds in the array
    index. The draws are at the pulsars' dtype. ECORR, ragged TOA counts
    and mixed devices or dtypes loop the pulsars (with ``fold(as_key(seed),
    g)`` keys)."""
    psrs = list(psrs)
    if not psrs:
        return
    place = _one_place(psrs)
    if add_ecorr or place is None or len({len(p.toas) for p in psrs}) != 1:
        base = None if seed is None else rng_utils.as_key(seed).cpu()
        for g, p in enumerate(psrs):
            s = None if base is None else rng_utils.fold(base, g)
            p.add_white_noise(add_ecorr=add_ecorr, randomize=randomize,
                              seed=s)
        return
    dev, dtype = place
    keys = _batch_keys(psrs, "white", seed, dev)
    params = [p._white_params(randomize, False) for p in psrs]
    par = _dev(np.stack([np.stack([p.toaerrs for p in psrs]),
                         np.stack([ef for ef, _, _ in params]),
                         np.stack([eq for _, eq, _ in params])]), dev, dtype)
    cur = _stack_current(psrs, dev, dtype)
    new = cur + white_ops.draw_white(
        keys, white_ops.white_sigma2(par[0], par[1], par[2]))
    for g, p in enumerate(psrs):
        p.residuals = new[g]


_GP_ARRAY_SIGNALS = {
    "red_noise": ("RN", 0.0, "add_red_noise"),
    "dm_gp": ("DM", 2.0, "add_dm_noise"),
    "chrom_gp": ("Sv", 4.0, "add_chromatic_noise"),
}


def add_noise_array(psrs, signal="red_noise", spectrum="powerlaw", f_psd=None,
                    seed=None, **kwargs):
    """Inject per-pulsar-independent GP noise across a whole array.

    Per-pulsar semantics of ``add_red_noise`` / ``add_dm_noise`` /
    ``add_chromatic_noise``: independent draws, noisedict resolution when no
    kwargs are given, re-injection replaces the prior realization; the
    draws are at the pulsars' dtype. A uniform array (one TOA count, Tspan
    and bin count, one device and dtype) draws and projects in one batch;
    any other falls back to the per-pulsar path. With ``seed=None`` each pulsar consumes its own key stream (the
    coefficients of a per-pulsar loop); with an explicit ``seed`` pulsar
    ``g`` draws from ``fold_in(key(seed), g)``.
    """
    psrs = list(psrs)
    if signal not in _GP_ARRAY_SIGNALS:
        raise KeyError(f"signal must be one of {sorted(_GP_ARRAY_SIGNALS)}, "
                       f"got {signal!r}")
    model_key, idx, method = _GP_ARRAY_SIGNALS[signal]
    if not psrs:
        return

    def fallback():
        base = None if seed is None else rng_utils.as_key(seed).cpu()
        for g, p in enumerate(psrs):
            s = None if base is None else rng_utils.fold(base, g)
            getattr(p, method)(spectrum=spectrum, f_psd=f_psd, seed=s,
                               **kwargs)

    comps = {p.custom_model.get(model_key) for p in psrs}
    if len(comps) != 1:
        return fallback()
    ncomp = comps.pop()
    if ncomp is None:
        return          # disabled for the whole array
    place = _one_place(psrs)
    if place is None or len({len(p.toas) for p in psrs}) != 1:
        return fallback()
    dev, dtype = place
    if f_psd is None:
        if len({float(p.Tspan) for p in psrs}) != 1:
            return fallback()
        f_shared = np.arange(1, ncomp + 1) / psrs[0].Tspan
    else:
        f_shared = np.asarray(f_psd, dtype=np.float64)
    olds = _batchable_olds(psrs, signal)
    if olds is None:
        return fallback()

    # resolve and validate every pulsar before any state changes
    resolved_list, psd_rows = [], []
    for p in psrs:
        psd, resolved = p._resolve_psd(signal, spectrum, f_shared,
                                       dict(kwargs))
        if len(psd) != len(f_shared):
            raise ValueError('"psd" and "f_psd" must have the same length')
        psd_rows.append(psd)
        resolved_list.append(resolved)

    tables = [p._phase_scale(f_shared, idx, 1400.0, None) for p in psrs]
    if any(isinstance(r, torch.Tensor) for r in psd_rows):
        psd = torch.stack([_dev(r, dev, dtype) for r in psd_rows])
    else:
        psd = _dev(np.stack(psd_rows), dev, dtype)
    cur = _stack_current(psrs, dev, dtype)
    keys = _batch_keys(psrs, signal, seed, dev)
    delta, four = _gp_draw(keys, np.stack([t[0] for t in tables]),
                           np.stack([t[1] for t in tables]), psd,
                           tables[0][2], len(f_shared), dev, dtype)
    if olds:
        o0 = olds[0]
        old_tabs = [p._phase_scale(np.asarray(o0["f"], dtype=np.float64),
                                   o0["idx"], o0.get("freqf", 1400.0), None)
                    for p in psrs]
        delta = delta - _gp_realization(
            np.stack([t[0] for t in old_tabs]),
            np.stack([t[1] for t in old_tabs]),
            np.stack([np.asarray(o["fourier"]) for o in olds]),
            old_tabs[0][2], dev, dtype)
    new = cur + delta
    four = four.cpu().numpy()
    for g, p in enumerate(psrs):
        if resolved_list[g]:
            p.update_noisedict(f"{p.name}_{signal}", resolved_list[g])
        p.residuals = new[g]
        p.signal_model[signal] = {
            "spectrum": spectrum,
            "f": f_shared,
            "psd": psd_rows[g],
            "fourier": four[g],
            "nbin": len(f_shared),
            "idx": idx,
            "freqf": 1400,
        }


def plot_pta(psrs, plot_name=True, show=True):
    """Mollweide sky map of the array, marker size ~ 1/mean(toaerr)."""
    import matplotlib.pyplot as plt

    ax = plt.axes(projection="mollweide")
    ax.grid(True, alpha=0.25)
    plt.xticks(np.pi - np.linspace(0.0, 2 * np.pi, 5),
               ["0h", "6h", "12h", "18h", "24h"], fontsize=14)
    plt.yticks(fontsize=14)
    for psr in psrs:
        size = 50 * (1e-6 / np.mean(psr.toaerrs))
        plt.scatter(np.pi - np.array(psr.phi), np.pi / 2 - np.array(psr.theta),
                    marker=(5, 1), s=size, color="r")
        if plot_name:
            plt.annotate(psr.name, (np.pi - psr.phi + 0.05,
                                    np.pi / 2 - psr.theta - 0.1),
                         color="k", fontsize=10)
    if show:
        plt.show()
    return ax


def copy_array(psrs, custom_noisedict=None, custom_models=None, seed=None,
               device: DeviceLike = None, dtype=None):
    """Clone an existing (ENTERPRISE- or facade-style, either package's)
    pulsar list: fresh :class:`Pulsar` objects whose observed attributes
    (toas, toaerrs, residuals, Mmat, fitpars, pdist, backend flags, freqs,
    planetssb, pos_t) are overwritten from the sources, with the noisedict
    re-resolved; the bridge for replaying real datasets. ``dtype=None``
    gives each copy its source's dtype (this package's pulsars carry one;
    float32, the constructor's default, for any other)."""
    dev = resolve_device(device)
    if custom_models is None:
        custom_models = {psr.name: None for psr in psrs}
    stream = rng_utils.KeyStream(seed, "copy_array")
    out = []
    for psr in psrs:
        fake = Pulsar(np.asarray(psr.toas), 1e-6, psr.theta, phi=psr.phi,
                      pdist=1.0, backends=list(np.unique(psr.backend_flags)),
                      custom_model=custom_models.get(psr.name),
                      seed=int(stream.host_rng(psr.name).integers(2**31)),
                      device=dev,
                      dtype=(getattr(psr, "_dtype", F32) if dtype is None
                             else dtype))
        fake.name = psr.name
        fake.toas = np.asarray(psr.toas, dtype=np.float64)
        fake.toaerrs = np.asarray(psr.toaerrs, dtype=np.float64)
        fake.residuals = np.asarray(psr.residuals, dtype=np.float64)
        fake.Tspan = float(fake.toas.max() - fake.toas.min())
        fake.nepochs = len(fake.toas)
        fake.Mmat = np.asarray(psr.Mmat)
        fake.fitpars = list(psr.fitpars)
        fake.pdist = psr.pdist
        fake.backend_flags = np.asarray(psr.backend_flags).astype(str)
        fake.backends = np.unique(fake.backend_flags)
        fake.freqs = np.asarray(psr.freqs, dtype=np.float64)
        fake.planetssb = getattr(psr, "planetssb", None)
        fake.pos_t = getattr(psr, "pos_t", None)
        fake.init_noisedict(custom_noisedict)
        out.append(fake)
    return out
