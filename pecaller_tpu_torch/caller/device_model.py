"""Genotype likelihoods vectorized over (sites, samples, genotypes) on a
torch device, and the reference's per-ref alpha prior (pecaller.c:
3043-3139) in numpy, the input of the screen's and the beam's tables.

Counterpart of ``pecaller_tpu/caller/device_model.py``.
``site_likelihoods`` is the float32 lgamma Dirichlet-multinomial of
fill_sample_like (pecaller.c:2448-2507) with the pass-1 flat alpha
prior, equal to the exact native engine up to rounding; the byte-exact
pipeline keeps the native engine.  Sites batch on a mesh's devices in
``parallel.mesh.sharded_call_step``.  ``site_program`` runs either
function as one device program an input shape, the counterpart of the
JAX package's ``@jax.jit``."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from ..mapper.program import StepProgram

NO_ALLELES = 6
MAX_GEN = 14


def _get_het_alleles(i, ref):
    pairs = {6: (0, 1), 7: (0, 2), 8: (0, 3), 9: (1, 2), 10: (1, 3),
             11: (2, 3), 12: (ref, 4), 13: (ref, 5)}
    return (i, i) if i < 6 else pairs[i]


def fill_alpha_prior_np(hom: int, het: int, ref: int) -> np.ndarray:
    """Numpy port of the reference's per-ref alpha prior
    (pecaller.c:3043-3139)."""
    a = np.zeros((MAX_GEN, NO_ALLELES), dtype=np.int64)
    hom_err = max(1, hom // 300)
    err = max(1, (2 * het) // 300)
    for i in range(4):
        a[i] = hom_err
        a[i, i] = hom
    a[4, :4] = err
    a[4, ref] = hom // 5
    a[4, 4] = (4 * hom) // 5
    a[4, 5] = err
    a[5, :4] = err
    a[5, ref] = hom
    a[5, 4] = err
    a[5, 5] = (4 * hom) // 5
    for j in range(6, 12):
        x, y = _get_het_alleles(j, ref)
        if x == ref or y == ref:
            r, o = (x, y) if x == ref else (y, x)
            a[j] = err
            a[j, r] = (51 * het) // 50
            a[j, o] = (49 * het) // 50
            a[j, 4] = max(1, het // 20)
            a[j, 5] = err
        else:
            a[j] = err
            a[j, x] = het
            a[j, y] = het
    a[12] = err
    a[12, 4] = (4 * het) // 5
    a[12, ref] = (6 * het) // 5
    a[12, 5] = err
    a[13] = err
    a[13, 5] = (2 * het) // 5
    a[13, ref] = (8 * het) // 5
    return a


_ALPHA_MEAN = np.stack([
    fill_alpha_prior_np(300, 150, r) /
    fill_alpha_prior_np(300, 150, r).sum(axis=1, keepdims=True)
    for r in range(4)])      # (4, 14, 6)


@functools.lru_cache(maxsize=None)
def _alpha_mean(device: torch.device) -> torch.Tensor:
    """``_ALPHA_MEAN`` in f32 on ``device`` (an indexed device), copied
    there once: a step that a CUDA graph captures may not copy from the
    host, so the first, eager call of a program fills this."""
    return torch.from_numpy(_ALPHA_MEAN.astype(np.float32)).to(device)


def site_likelihoods(reads, ref_int, norm: float = 1.0):
    """(S, I, 6) counts (int16 bits of uint16, or a wider integer type)
    + (S,) ref -> (S, I, 14) f32 log-likes on the inputs' device.

    Mirrors fill_sample_like with the pass-1 flat alpha prior: the
    Dirichlet-multinomial log pmf with per-sample concentration
    scale = clip(min(tot,100)*norm, 10, 1000), alpha = ceil(scale*mean).
    """
    reads = (reads.to(torch.int32) & 0xFFFF).to(torch.float32)
    tot = reads[..., :5].sum(-1)                      # (S, I)
    scale = (tot.clamp(max=100.0) * norm).clamp(10.0, 1000.0)
    mean = _alpha_mean(reads.device)[ref_int.long()]  # (S, 14, 6)
    alpha = torch.ceil(scale[:, :, None, None]
                       * mean[:, None, :, :]).clamp(min=1.0)
    r = reads[:, :, None, :]                          # (S, I, 1, 6)
    lg = torch.lgamma
    a_tot = alpha.sum(-1)
    t_tot = (alpha + r).sum(-1)
    return (lg(alpha + r).sum(-1) - lg(alpha).sum(-1)
            + lg(a_tot) - lg(t_tot)
            + lg(tot[:, :, None] + 1.0) - lg(r + 1.0).sum(-1))


def site_posteriors_flat(reads, ref_int, ln_theta: float):
    """Per-sample genotype posteriors under an independent-sample
    approximation: likelihood + theta prior per non-ref genotype,
    softmax over genotypes.  For throughput measurement and screening;
    the exact joint-configuration search refines flagged sites."""
    like = site_likelihoods(reads, ref_int)
    g = torch.arange(MAX_GEN, device=like.device)
    is_ref_hom = g == ref_int.long()[:, None, None]
    post = like + torch.where(is_ref_hom, 0.0, float(np.float32(ln_theta)))
    return torch.softmax(post, dim=-1)


def site_program(fn, device=None, graph: bool = True, **kw):
    """``fn`` (``site_likelihoods`` or ``site_posteriors_flat``, with its
    keyword arguments ``kw``) as one ``mapper.program.StepProgram`` an
    input shape on ``device`` (None: ``cuda:0``): on a card a CUDA graph,
    captured at a shape's second call and replayed after.  Returns
    ``step(reads, ref_int)``, which takes host arrays (uint16 counts
    travel as int16 bits) or tensors and returns the program's output:
    the next call of the same shape overwrites it, so copy it out
    first.  ``step.programs`` maps each input shape to its program;
    ``graph=False`` runs ``fn`` eagerly at every call."""
    dev = torch.empty(0, device=resolve_device(device)).device
    _alpha_mean(dev)
    programs = {}

    def step(reads, ref_int):
        if isinstance(reads, np.ndarray) and reads.dtype == np.uint16:
            reads = reads.view(np.int16)
        key = tuple((tuple(x.shape), str(x.dtype)) for x in (reads, ref_int))
        if key not in programs:
            programs[key] = StepProgram(functools.partial(fn, **kw), dev,
                                        graph=graph)
        return programs[key]([(reads, ref_int)])[0]
    step.programs = programs
    return step
