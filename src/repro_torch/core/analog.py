"""Charge-sharing analog model (paper §3.1.1, §5.1; Figs 4 & 11).

The port's copy of ``repro.core.analog``. Charge conservation on a bitline
precharged to VDD/2 when a set of cells is simultaneously connected:

    dV = sum_i C_i * (V_i - VDD/2) / (C_bl + sum_i C_i)

Data cells hold V_i in {0, VDD}; Frac-neutral cells hold ~VDD/2 and
therefore add denominator capacitance without moving the numerator. The
sense amplifier resolves sign(dV - offset + noise).

Per-bitline *static* draws (process variation): cell capacitances
C_i ~ N(C, (pv*C)^2) and sense offset ~ N(0, sigma_off). Per-trial
*dynamic* noise: N(0, sigma_trial) plus data-pattern coupling
~ N(0, sigma_cpl*sqrt(N)). A bitline counts as stable only if its static
margin exceeds the ~3.9-sigma tail of the trial noise (the paper's
10^4-trial success criterion).

Every Monte-Carlo function is split in two:

* a *draw* step (:func:`draw_bitlines`, :func:`draw_patterns`) that takes
  an explicit ``torch.Generator`` — the generator's device is where the
  model runs;
* a draw-free *core* (:func:`worst_margins_from_draws`,
  :func:`column_profile_from_draws`) that takes the caps, offsets and
  patterns as tensors. The core's bitline deviation runs through
  ``ops.charge_share``, so on a CUDA device it is the charge-sharing
  kernel.

``jax.random`` cannot be reproduced in torch, and CPU and CUDA torch
generators differ from each other too: the same seed gives the same draws
only on the same device type. Exact agreement with the reference goes
through the draw-free core fed the reference's own draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.profiles import MfrProfile
from repro_torch.kernels import ops

# Quantile of the max |N(0,1)| over ~1e4 trials: P(|z| < q)^(1e4) ~ 0.5
TRIAL_TAIL_SIGMA = 3.9


def seeded_generator(seed: int, device="cuda") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (a CUDA
    device on a host without a card raises)."""
    from repro_torch.core.engine import resolve_device
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))
    return gen


@dataclasses.dataclass(frozen=True)
class BitlineSample:
    """Per-bitline static condition draws."""
    cell_caps: torch.Tensor     # [n_rows, n_bitlines] float32 femto-farads
    sense_offset: torch.Tensor  # [n_bitlines] float32 volts


def draw_bitlines(gen: torch.Generator, profile: MfrProfile, n_rows: int,
                  n_bitlines: int, process_variation: float | None = None
                  ) -> BitlineSample:
    """Cell capacitances and sense offsets of ``n_bitlines`` bitlines of
    ``n_rows`` cells, drawn from ``gen`` on its device."""
    pv = float(profile.process_variation if process_variation is None
               else process_variation)
    normal = torch.randn((n_rows, n_bitlines), generator=gen,
                         device=gen.device)
    caps = profile.cell_cap_ff * (1.0 + pv * normal)
    caps = caps.clamp_min(0.05 * profile.cell_cap_ff)
    offs = profile.sense_offset_sigma * torch.randn(
        (n_bitlines,), generator=gen, device=gen.device)
    return BitlineSample(cell_caps=caps, sense_offset=offs)


def draw_patterns(gen: torch.Generator, n_patterns: int, m_inputs: int,
                  n_bitlines: int) -> torch.Tensor:
    """Random input patterns: [n_patterns, m_inputs, n_bitlines] float32
    in {0, 1}, each bit 1 with probability 1/2."""
    u = torch.rand((n_patterns, m_inputs, n_bitlines), generator=gen,
                   device=gen.device)
    return (u < 0.5).to(torch.float32)


def bitline_deviation(cell_values: torch.Tensor, neutral_mask: torch.Tensor,
                      cell_caps: torch.Tensor, *, vdd: float,
                      c_bl: float) -> torch.Tensor:
    """dV per bitline.

    cell_values: [n_rows, B] or [P, n_rows, B] in {0,1}; neutral_mask:
    [n_rows] bool (Frac rows, which hold VDD/2); cell_caps: [n_rows, B].
    Returns [B] or [P, B] volts, through ``ops.charge_share``.
    """
    v = torch.where(neutral_mask[:, None], 0.5 * vdd,
                    cell_values.to(torch.float32) * vdd)
    return ops.charge_share(v.contiguous(), cell_caps.contiguous(),
                            vdd=vdd, c_bl=c_bl)


def trial_sigma(profile: MfrProfile, n_rows: int) -> torch.Tensor:
    """Per-trial noise sigma (float32 scalar) for an ``n_rows``
    activation: thermal trial noise plus data-pattern coupling."""
    var = profile.trial_noise_sigma ** 2 + profile.coupling_sigma ** 2 * n_rows
    return torch.sqrt(torch.tensor(var, dtype=torch.float32))


def _neutral_mask(n_data: int, n_neutral: int, device) -> torch.Tensor:
    return torch.cat([torch.zeros(n_data, dtype=torch.bool, device=device),
                      torch.ones(n_neutral, dtype=torch.bool, device=device)])


def worst_margins_from_draws(profile: MfrProfile, sample: BitlineSample,
                             patterns: torch.Tensor, *, copies: int,
                             n_neutral: int
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Worst-case per-bitline sensing margin over ``patterns`` ([P,
    m_inputs, B] in {0,1}), each input replicated ``copies`` times plus
    ``n_neutral`` Frac rows (Fig 10), and the per-trial noise sigma.
    Returns ``(worst [B], sigma)`` float32 on the draws' device."""
    n_pat, m_inputs, n_bl = patterns.shape
    dev = patterns.device
    cells = patterns.repeat_interleave(copies, dim=1)  # replication
    if n_neutral:
        cells = torch.cat([cells, cells.new_zeros((n_pat, n_neutral, n_bl))],
                          dim=1)
    neutral = _neutral_mask(m_inputs * copies, n_neutral, dev)
    dv = bitline_deviation(cells, neutral, sample.cell_caps,
                           vdd=profile.vdd, c_bl=profile.bitline_cap_ff)
    maj = patterns.sum(dim=1) > m_inputs / 2
    sign = torch.where(maj, 1.0, -1.0)
    # Sensed bit = (dv - offset + noise) > 0; the margin toward the
    # correct value is sign * (dv - offset).
    margins = sign * (dv - sample.sense_offset)
    worst = margins.amin(dim=0)
    return worst, trial_sigma(profile, cells.shape[1]).to(dev)


def draw_margin_inputs(gen: torch.Generator, profile: MfrProfile, *,
                       m_inputs: int, copies: int, n_neutral: int,
                       n_bitlines: int, n_patterns: int,
                       process_variation: float | None
                       ) -> tuple[BitlineSample, torch.Tensor]:
    """The draw step of :func:`worst_margins_from_draws`: the bitlines
    of an ``m_inputs * copies + n_neutral`` row activation, then the
    patterns, from ``gen``."""
    n_rows = m_inputs * copies + n_neutral
    sample = draw_bitlines(gen, profile, n_rows, n_bitlines,
                           process_variation)
    return sample, draw_patterns(gen, n_patterns, m_inputs, n_bitlines)


def stable_and_flip(worst: torch.Tensor, sigma: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable mask (``worst > 3.9 sigma``) and per-column per-trial flip
    probability ``0.5 * erfc(worst / (sigma * sqrt 2))``, both computed
    in float32 as the reference does; the flip probability is clipped to
    [0, 1]."""
    stable = worst > TRIAL_TAIL_SIGMA * sigma
    root2 = torch.sqrt(torch.tensor(2.0, dtype=torch.float32,
                                    device=worst.device))
    flip = 0.5 * torch.special.erfc(worst / (sigma * root2))
    return stable, flip.clamp(0.0, 1.0)


def maj_success_rate(gen: torch.Generator, profile: MfrProfile, *,
                     m_inputs: int, copies: int, n_neutral: int,
                     n_bitlines: int = 4096, n_patterns: int = 64,
                     process_variation: float | None = None,
                     ) -> tuple[float, torch.Tensor]:
    """Monte-Carlo success rate of MAJ-M with input replication.

    Returns (mean success rate, per-bitline stable mask on ``gen``'s
    device)."""
    sample, patterns = draw_margin_inputs(
        gen, profile, m_inputs=m_inputs, copies=copies, n_neutral=n_neutral,
        n_bitlines=n_bitlines, n_patterns=n_patterns,
        process_variation=process_variation)
    worst, sigma = worst_margins_from_draws(profile, sample, patterns,
                                            copies=copies,
                                            n_neutral=n_neutral)
    stable, _ = stable_and_flip(worst, sigma)
    return float(stable.to(torch.float32).mean()), stable


@dataclasses.dataclass(frozen=True)
class ColumnProfile:
    """One Monte-Carlo characterization of a row group's bitlines.

    ``rate``/``stable`` match :func:`maj_success_rate` exactly (the same
    margin draws); ``flip_p`` adds the per-column *per-trial* failure
    probability Phi(-worst / sigma), which the reliability plane's fault
    injector uses as the bit-flip rate of each column.
    """
    rate: float
    stable: np.ndarray  # bool  [n_bitlines]
    flip_p: np.ndarray  # float [n_bitlines], per-trial failure probability


def column_profile_from_draws(profile: MfrProfile, sample: BitlineSample,
                              patterns: torch.Tensor, *, copies: int,
                              n_neutral: int) -> ColumnProfile:
    """The draw-free core of :func:`column_flip_probs`."""
    worst, sigma = worst_margins_from_draws(profile, sample, patterns,
                                            copies=copies,
                                            n_neutral=n_neutral)
    stable, flip = stable_and_flip(worst, sigma)
    return ColumnProfile(rate=float(stable.to(torch.float32).mean()),
                         stable=stable.cpu().numpy(),
                         flip_p=flip.cpu().numpy().astype(np.float64))


def column_flip_probs(gen: torch.Generator, profile: MfrProfile, *,
                      m_inputs: int, copies: int, n_neutral: int,
                      n_bitlines: int = 4096, n_patterns: int = 64,
                      process_variation: float | None = None
                      ) -> ColumnProfile:
    """Per-column characterization for calibration maps
    (``repro_torch.reliability``): the stable mask and success rate of
    :func:`maj_success_rate` plus each bitline's worst-case static margin
    turned into a per-trial flip probability through the Gaussian noise
    tail. A column with a *negative* worst margin has ``flip_p > 0.5``."""
    sample, patterns = draw_margin_inputs(
        gen, profile, m_inputs=m_inputs, copies=copies, n_neutral=n_neutral,
        n_bitlines=n_bitlines, n_patterns=n_patterns,
        process_variation=process_variation)
    return column_profile_from_draws(profile, sample, patterns,
                                     copies=copies, n_neutral=n_neutral)


def deviation_distribution(gen: torch.Generator, profile: MfrProfile, *,
                           m_inputs: int, copies: int, n_neutral: int,
                           ones: int, n_bitlines: int = 4096,
                           process_variation: float | None = None
                           ) -> torch.Tensor:
    """dV distribution [B] for a fixed input pattern with ``ones`` logic-1
    inputs out of ``m_inputs`` (Figs 4b / 11a)."""
    n_rows = m_inputs * copies + n_neutral
    sample = draw_bitlines(gen, profile, n_rows, n_bitlines,
                           process_variation)
    dev = gen.device
    pat = torch.cat([torch.ones(ones, device=dev),
                     torch.zeros(m_inputs - ones, device=dev)])
    cells = pat.repeat_interleave(copies)[:, None].expand(-1, n_bitlines)
    cells = torch.cat([cells, torch.zeros((n_neutral, n_bitlines),
                                          device=dev)])
    neutral = _neutral_mask(m_inputs * copies, n_neutral, dev)
    return bitline_deviation(cells, neutral, sample.cell_caps,
                             vdd=profile.vdd, c_bl=profile.bitline_cap_ff)


def single_row_deviation(gen: torch.Generator, profile: MfrProfile, *,
                         n_bitlines: int = 4096,
                         process_variation: float | None = None
                         ) -> torch.Tensor:
    """Nominal single-row activation deviation (Fig 4b comparison
    point)."""
    return deviation_distribution(
        gen, profile, m_inputs=1, copies=1, n_neutral=0, ones=1,
        n_bitlines=n_bitlines, process_variation=process_variation)
