"""Candidate trajectory sampler — host-side numpy (data-prep, like the
reference; stp3/utils/sampler.py:8-146). The port's own copy of
stp3_tpu/utils/sampler.py: the same draws in the same order.

Given the ego's current speed ``v0`` and steering curvature ``kappa``,
samples ``m`` candidate trajectories over timestamps ``tt`` as a mix of
straight lines, constant-curvature circles, and Fresnel-integral clothoids
with randomized accelerations/velocities. Output (m, len(tt), 3) columns
(x_lateral, y_longitudinal, heading), sorted by terminal x so the
LEFT/FORWARD/RIGHT thirds are positional (consumed by the planner's
command gather, models/planning_model.py).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from scipy.special import fresnel


def sample(v0: float, kappa: float, t0: np.ndarray, n0: np.ndarray,
           tt: np.ndarray, m: int, possibility: Optional[Sequence[float]] = None,
           rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Sample m candidate trajectories (see module docstring).

    t0: (2,) initial tangent (longitudinal) direction; n0: (2,) normal.
    possibility: (left, straight, right) mixture weights, default
    (0.4, 0.2, 0.4) like the reference (sampler.py:21-27).
    """
    if possibility is None:
        possibility = (0.4, 0.2, 0.4)
    if rng is None:
        rng = np.random  # module-level RNG, like the reference

    left_num = int(m * possibility[0])
    right_num = int(m * possibility[2])
    # reference uses int(m * p[1]) which under-counts when m isn't divisible;
    # take the remainder so the groups always sum to m
    straight_num = m - left_num - right_num
    curve_num = left_num + right_num

    # accelerations in [-3, 7] m/s^2; velocities: keep v0 20% of the time,
    # otherwise a random one <= 15 m/s (reference sampler.py:29-36:
    # v_selections = rand >= 0.2 picks the RANDOM row with p=0.8)
    accelerations = 10.0 * (rng.rand(m) - 0.5) + 2.0
    v_random = 15.0 * rng.rand(m)
    keep_v0 = rng.rand(m) < 0.2
    velocities = np.where(keep_v0, np.full(m, v0), v_random)

    # longitudinal arc length per timestamp
    arc = velocities[:, None] * tt[None, :] + accelerations[:, None] * tt[None, :] ** 2 / 2.0
    arc_straight, arc_curve = arc[:straight_num], arc[straight_num:]

    # ---------------- straight lines
    line_pts = arc_straight[:, :, None] * t0[None, None, :]
    lines = np.concatenate([line_pts, np.zeros_like(arc_straight)[:, :, None]], axis=-1)

    # ---------------- circles at the steering curvature
    k = min(-0.01, kappa) if kappa <= 0 else max(0.01, kappa)
    radius = abs(1.0 / k)
    center = np.array([-1.0 / k, 0.0])
    phi = arc_curve / radius if k >= 0 else np.pi - arc_curve / radius
    circle_pts = np.stack([center[0] + radius * np.cos(phi),
                           center[1] + radius * np.sin(phi)], axis=-1)
    theta_c = arc_curve / radius if k >= 0 else -arc_curve / radius
    theta_c = (theta_c + np.pi) % (2 * np.pi) - np.pi
    circles = np.concatenate([circle_pts, theta_c[:, :, None]], axis=-1)

    # ---------------- clothoids (Euler spirals)
    alphas = (80.0 - 6.0) * rng.rand(curve_num) + 6.0
    xi0 = abs(kappa) / np.pi
    xis = xi0 + arc_curve
    ss, cs = fresnel(xis / alphas[:, None])
    cl_pts = alphas[:, None, None] * (cs[:, :, None] * t0[None, None, :]
                                      + ss[:, :, None] * n0[None, None, :])
    xs = cl_pts[:, :, 0] - cl_pts[:, 0, 0, None]
    ys = cl_pts[:, :, 1] - cl_pts[:, 0, 1, None]
    theta0 = 0.5 * np.pi * ((kappa / np.pi / alphas) ** 2)[:, None]
    signed_theta0 = theta0 * np.sign(kappa)
    cl_pts[:, :, 0] = np.cos(signed_theta0) * xs + np.sin(signed_theta0) * ys
    cl_pts[:, :, 1] = -np.sin(signed_theta0) * xs + np.cos(signed_theta0) * ys
    theta_cl = 0.5 * np.pi * (xis / alphas[:, None]) ** 2 - theta0
    signed = theta_cl * np.sign(kappa)
    wrapped = (signed + np.pi) % (2 * np.pi) - np.pi
    clothoids = np.concatenate([cl_pts, wrapped[:, :, None]], axis=-1)

    # 80% clothoids / 20% circles for the curved candidates (sampler.py:105-110)
    pick_clothoid = rng.rand(curve_num) < 0.8
    curves = np.where(pick_clothoid[:, None, None], clothoids, circles)

    # mirror half of the curves to the other side (sampler.py:128-140)
    def mirrored(c):
        return np.stack([-c[..., 0], c[..., 1], -c[..., 2]], axis=-1)

    if kappa > 0:
        left_curve = curves[:left_num]
        right_curve = mirrored(curves[left_num:curve_num])
    else:
        right_curve = curves[:left_num]
        left_curve = mirrored(curves[left_num:curve_num])

    trajectories = np.concatenate([left_curve, lines, right_curve], axis=0)
    order = np.argsort(trajectories[:, -1, 0])
    return trajectories[order]


def sample_trajectories(v0: float, steering: float, n_future: int, n_samples: int,
                        sample_interval: float = 0.5, flip_steering: bool = False,
                        rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Convenience wrapper matching the dataset-side invocation
    (reference NuscenesData.py:389-437): fine 10x time sampling then
    decimation; kappa = 2*steering/2.588; (n_samples, n_future+1, 3)."""
    if flip_steering:
        steering = -steering
    kappa = 2.0 * steering / 2.588
    t0 = np.array([0.0, 1.0])
    n0 = np.array([1.0, 0.0]) if kappa <= 0 else np.array([-1.0, 0.0])
    t_end = n_future * sample_interval
    t_interval = sample_interval / 10.0
    tt = np.arange(0.0, t_end + t_interval, t_interval)
    fine = sample(v0, kappa, t0, n0, tt, n_samples, rng=rng)
    return fine[:, ::10]
