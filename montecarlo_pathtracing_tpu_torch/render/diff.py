"""Differentiable rendering: pixel gradients w.r.t. scene parameters.

Port of montecarlo_pathtracing_tpu/render/diff.py, with torch autograd in
place of jax.grad. The reference is a forward-only GL renderer (SURVEY.md
§2.3 "Gradient/differentiability: None"). Every route of the integrator
that gradients take is torch ops around the trace, so reverse-mode AD
through the bounce loop gives pixel gradients directly. Sampling is
DETACHED (detach_sampling=True detaches the sampled directions):
gradients flow through the throughput/attenuation chain, the
Schlick/spec factors and emission — the detached-sampling path-replay
estimator — while the non-differentiable discrete decisions (hit
selection, material case, the mixed-case coin) replay identically
because they only depend on the RNG counters and comparisons.
Differentiable inputs:

  - per-prim albedo/alpha (scene.color), material vector
    (shininess, roughness, emissivity, area) (scene.mat)
  - the IOR slider (refract_ind) — including its geometric effect through
    the refraction directions, on the dense route
  - a global light_scale multiplying emissivity (the light-intensity knob;
    the reference bakes intensity into emissive materials at scene build)

Two routes: use_kernels=False is the dense route (the trace in the
backward pass, the full IOR gradient); use_kernels=True is the
pallas-trace route with its trace detached (models/montecarlo.raytrace:
detach_sampling turns the megakernel and fused routes off), whose
trace kernels K3a-K6 need no backward. On CPU tensors the kernels' plain
versions run.

`inverse_render_fit` is the BASELINE config-4 demo: recover one object's
material from a target render by gradient descent (torch.optim.Adam with
optax.adam's defaults).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..models.registry import get_integrator
from ..scene.device import DeviceScene


class SceneParams(NamedTuple):
    """The differentiable leaves, separated from the frozen scene."""
    color: torch.Tensor        # [N,4]
    mat: torch.Tensor          # [N,4]
    refract_ind: torch.Tensor  # 0-dim
    light_scale: torch.Tensor  # 0-dim, multiplies emissivity


def params_of(scene: DeviceScene, refract_ind=1.0) -> SceneParams:
    """The scene's own leaves, on its device."""
    f32 = dict(dtype=torch.float32, device=scene.device)
    return SceneParams(
        color=scene.color,
        mat=scene.mat,
        refract_ind=torch.tensor(refract_ind, **f32),
        light_scale=torch.tensor(1.0, **f32),
    )


def apply_params(scene: DeviceScene, p: SceneParams) -> DeviceScene:
    """The scene with the leaves in place, out of place: emissivity
    (mat column 2) is scaled by a product with a built row, so no leaf is
    written. The static fields, has_transparent among them, pass through
    as compile_scene set them."""
    one = torch.ones_like(p.light_scale)
    mat = p.mat * torch.stack([one, one, p.light_scale, one])
    return dataclasses.replace(scene, color=p.color, mat=mat)


def _auto_fast(scene: DeviceScene) -> bool:
    return scene.device.type == "cuda"


def render_mean(scene: DeviceScene, params: SceneParams, origin, dirs, tc,
                n_passes: int, nb_bounces: int,
                integrator: str = "montecarlo", use_kernels: bool = False):
    """Mean of n_passes progressive passes (pass indices 0 .. n_passes-1)
    — the differentiable render. dirs/tc: [N,3]/[N,2] flattened rays.
    Returns [N,3].

    use_kernels routes through the trace kernels with the trace DETACHED
    from the autograd graph (no kernel backward needed; exact for
    color/mat/light gradients, drops only the geometric IOR term — see
    models/montecarlo.raytrace). The dense route keeps the full IOR
    gradient and remains the parity reference."""
    fn = get_integrator(integrator)
    scene = apply_params(scene, params)
    acc = torch.zeros(dirs.shape[:-1] + (3,), dtype=torch.float32,
                      device=dirs.device)
    for k in range(n_passes):
        acc = acc + fn(scene, origin, dirs, tc, k, nb_bounces=nb_bounces,
                       refract_ind=params.refract_ind, detach_sampling=True,
                       use_kernels=use_kernels)
    return acc / n_passes


def _grad(out, leaves):
    """torch.autograd.grad with zeros for leaves the output does not
    reach, as jax.grad gives."""
    g = torch.autograd.grad(out, leaves, allow_unused=True)
    return SceneParams(*(torch.zeros_like(x) if gi is None else gi
                         for x, gi in zip(leaves, g)))


def pixel_grads(scene, params, origin, dirs, tc, *, n_passes=1,
                nb_bounces=3, integrator="montecarlo",
                use_kernels: bool | None = None) -> SceneParams:
    """Gradient of the mean pixel luminance w.r.t. every scene parameter —
    the 'pixel-grad' quantity checked against the CPU reference
    (BASELINE.json metric). use_kernels None = auto (the kernels when the
    scene is on the card)."""
    if use_kernels is None:
        use_kernels = _auto_fast(scene)
    # new autograd leaves sharing the parameters' storage
    p = SceneParams(*(t.detach().requires_grad_(True) for t in params))
    img = render_mean(scene, p, origin, dirs, tc, n_passes, nb_bounces,
                      integrator, use_kernels)
    return _grad(img.mean(), p)


def inverse_render_fit(scene, target, origin, dirs, tc, *, prim_ids,
                       steps=100, lr=5e-2, n_passes=2, nb_bounces=3,
                       fit_albedo=True, fit_alpha=False, fit_mat_cols=(),
                       fit_ior=False, fit_light=False,
                       seed_params=None, verbose=False,
                       use_kernels: bool | None = None):
    """BASELINE config 4: recover the albedo/roughness (and optionally IOR)
    of the prims in `prim_ids` from a target image by Adam descent.
    Only the selected prims' color/mat rows receive updates (a mask is
    applied to the gradients). Fit scope is masked per row AND per
    channel: by default only the albedo RGB moves. This matters — the
    4-case material logic branches on exact comparisons (alpha == 1,
    shininess == 0, tp/montecarlo.frag:141-169), so letting the optimizer
    drift shininess or alpha across a case boundary makes the loss
    landscape discontinuous. Opt in via fit_alpha / fit_mat_cols (columns
    of (shininess, roughness, emissivity, area)) / fit_ior / fit_light
    when the target genuinely differs in those. Returns (params, losses),
    one Python float per step.

    Routing: use_kernels None (auto) picks the kernels on the card —
    EXCEPT when fit_ior is set, which forces the dense route: the fast
    route's detached trace drops the geometric IOR term, and the
    reference's clamped-Schlick quirk zeroes the retained term, so the
    fast refract_ind gradient is ~0 and the fit would never move
    (models/montecarlo.raytrace)."""
    if use_kernels is None:
        use_kernels = _auto_fast(scene) and not fit_ior
    p0 = seed_params if seed_params is not None else params_of(scene)
    leaves = SceneParams(*(t.detach().clone().requires_grad_(True)
                           for t in p0))
    f32 = dict(dtype=torch.float32, device=scene.device)
    row_mask = torch.zeros((scene.color.shape[0], 1), **f32)
    for i in prim_ids:
        row_mask[i] = 1.0
    color_ch = torch.tensor(
        [[1.0 if fit_albedo else 0.0] * 3 + [1.0 if fit_alpha else 0.0]],
        **f32)
    mat_ch = torch.zeros((1, 4), **f32)
    for c in fit_mat_cols:
        mat_ch[0, c] = 1.0
    color_mask = row_mask * color_ch
    mat_mask = row_mask * mat_ch
    mat_hi = torch.tensor([1.0, 1.0, 1e6, 1e6], **f32)

    # optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    # the same bias-corrected update
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for i in range(steps):
        img = render_mean(scene, leaves, origin, dirs, tc, n_passes,
                          nb_bounces, "montecarlo", use_kernels)
        loss = torch.mean((img - target) ** 2)
        g = _grad(loss, leaves)
        g = g._replace(
            color=g.color * color_mask,
            mat=g.mat * mat_mask,
            refract_ind=g.refract_ind if fit_ior
            else torch.zeros_like(g.refract_ind),
            light_scale=g.light_scale if fit_light
            else torch.zeros_like(g.light_scale),
        )
        for leaf, gi in zip(leaves, g):
            leaf.grad = gi
        opt.step()
        # keep parameters in their physical ranges
        with torch.no_grad():
            leaves.color.clamp_(0.0, 1.0)
            leaves.mat.copy_(torch.minimum(leaves.mat.clamp(min=0.0),
                                           mat_hi))
            leaves.refract_ind.clamp_(1.0, 2.5)
        losses.append(float(loss.detach()))
        if verbose and i % 10 == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
    return SceneParams(*(t.detach() for t in leaves)), losses
