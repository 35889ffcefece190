"""DPM-Solver samplers (port of minddiffusion_tpu/samplers/dpm_solver.py):
multistep and singlestep orders 1-3, the adaptive step-size solver; data
(DPM-Solver++, the default) or noise prediction; dynamic thresholding.

As in the JAX package, every per-step scalar (lambda / sigma / alpha at the
time nodes, the expm1 coefficients, the r0/r1 step ratios, the order gates)
is a host table built in fp64 numpy and stored as fp32, and the model takes
continuous times in [0, 999]: t_input = (t - 1/N) * 1000. The step loops are
Python loops; the adaptive solver's `lax.while_loop` becomes one too.

The multistep and singlestep solvers take the JAX signatures' latent
inpaint blending: with `mask` (1 = keep) and `x0`, each update is followed
by x <- q_sample(x0, t) * mask + x * (1 - mask) at the integer timestep of
the node just reached, the noise drawn from `generator`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from minddiffusion_tpu_torch.core.schedules import DiffusionSchedule
from minddiffusion_tpu_torch.samplers import common


def _time_nodes(steps: int, t_T: float, t_0: float, skip_type: str) -> np.ndarray:
    if skip_type == "time_uniform":
        return np.linspace(t_T, t_0, steps + 1)
    if skip_type == "time_quadratic":
        return np.linspace(t_T ** (1 / 2), t_0 ** (1 / 2), steps + 1) ** 2
    raise ValueError(f"unsupported skip_type: {skip_type!r}")


def _discrete(schedule: DiffusionSchedule):
    """(N, t grid (1..N)/N, log alpha on it), fp64."""
    ac = schedule.alphas_cumprod.double().numpy()
    n = ac.shape[0]
    return n, np.arange(1, n + 1, dtype=np.float64) / n, 0.5 * np.log(ac)


def _marginals(t, t_disc, log_alpha_disc):
    """(alpha, sigma, lambda) at continuous times t, fp64."""
    la = np.interp(t, t_disc, log_alpha_disc)
    sigma = np.sqrt(np.maximum(1.0 - np.exp(2.0 * la), 1e-20))
    return np.exp(la), sigma, la - np.log(sigma)


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def build_tables(schedule: DiffusionSchedule, steps: int,
                 skip_type: str = "time_uniform", order: int = 2,
                 lower_order_final: bool = True, prediction: str = "data") -> dict:
    """Host fp32 tables for the multistep solver, orders 1-3.

    prediction="data": DPM-Solver++ coefficients (sigma-ratio carry,
    alpha * expm1(-h) bases). "noise": plain DPM-Solver (alpha-ratio carry,
    sigma * expm1(h) bases; the 3M correction signs are baked into cd1/cd2
    so one update serves both)."""
    if order not in (1, 2, 3):
        raise NotImplementedError("multistep order must be 1, 2 or 3")
    if prediction not in ("data", "noise"):
        raise NotImplementedError("prediction must be 'data' or 'noise'")
    n, t_disc, log_alpha_disc = _discrete(schedule)
    t_nodes = _time_nodes(steps, t_T=1.0, t_0=1.0 / n, skip_type=skip_type)
    alpha, sigma, lam = _marginals(t_nodes, t_disc, log_alpha_disc)
    model_t = (t_nodes - 1.0 / n) * 1000.0

    h = lam[1:] - lam[:-1]                       # step i: node i -> i+1
    safe_h = np.where(h != 0, h, 1.0)
    h_prev = np.concatenate([[h[0]], h[:-1]])
    h_prev2 = np.concatenate([[h[0], h[0]], h[:-2]])
    r0 = h_prev / safe_h
    r1 = h_prev2 / safe_h
    phi = np.expm1(-h)
    phi_p = np.expm1(h)

    idx = np.arange(1, steps + 1)
    step_order = np.minimum(order, idx)          # ramp 1 -> 2 -> 3
    if lower_order_final and steps < 15:
        step_order = np.minimum(step_order, steps + 1 - idx)
    if prediction == "data":
        ratio = sigma[1:] / sigma[:-1]
        c0 = alpha[1:] * phi
        cd1 = alpha[1:] * (phi / safe_h + 1.0)
        cd2 = alpha[1:] * ((phi + h) / safe_h ** 2 - 0.5)
    else:
        ratio = alpha[1:] / alpha[:-1]
        c0 = sigma[1:] * phi_p
        cd1 = -sigma[1:] * (phi_p / safe_h - 1.0)
        cd2 = sigma[1:] * ((phi_p - h) / safe_h ** 2 - 0.5)
    return dict(model_t=_f32(model_t), ratio=_f32(ratio), c0=_f32(c0),
                cd1=_f32(cd1), cd2=_f32(cd2),
                r0=_f32(np.where(r0 != 0, r0, 1.0)), r1=_f32(np.where(r1 != 0, r1, 1.0)),
                o2=_f32(step_order >= 2), o3=_f32(step_order >= 3),
                node_alpha=_f32(alpha), node_sigma=_f32(sigma))


def _dynamic_threshold(x0: torch.Tensor, max_val: float, p: float = 0.995) -> torch.Tensor:
    """Per-sample p-quantile s of |x0|, clamped >= max_val; clip to [-s, s]
    and rescale by s."""
    s = torch.quantile(x0.abs().reshape(x0.shape[0], -1), p, dim=1)
    s = torch.clamp(s, min=max_val).reshape((-1,) + (1,) * (x0.ndim - 1))
    return torch.clamp(x0, -s, s) / s


def _model_fn(eps_fn: common.EpsFn, prediction: str, thresholding: bool,
              max_val: float):
    """The solver's model output at a node: the data prediction (++), or the
    noise prediction; optional dynamic thresholding (data mode only)."""
    def f(x: torch.Tensor, t_node, a, s) -> torch.Tensor:
        eps = eps_fn(x, common.broadcast_time(t_node, x.device)).float()
        if prediction == "noise":
            return eps
        x0 = (x - float(s) * eps) / float(a)
        return _dynamic_threshold(x0, max_val) if thresholding else x0
    return f


def _check_thresholding(thresholding: bool, prediction: str) -> None:
    if thresholding and prediction != "data":
        raise ValueError("thresholding applies to data prediction only")


def sample(eps_fn: common.EpsFn, x_T: torch.Tensor, schedule: DiffusionSchedule,
           steps: int = 15, order: int = 2, skip_type: str = "time_uniform",
           lower_order_final: bool = True, prediction: str = "data",
           thresholding: bool = False, thresholding_max_val: float = 1.0,
           mask: Optional[torch.Tensor] = None, x0: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """DPM-Solver multistep: `steps` model evals; returns the final latent (fp32).
    With `mask`/`x0`, step i blends at timestep int(model_t[i + 1]) (the fp32
    model time truncated, clipped to the schedule), as the JAX solver does."""
    _check_thresholding(thresholding, prediction)
    tab = build_tables(schedule, steps, skip_type, order, lower_order_final, prediction)
    f = _model_fn(eps_fn, prediction, thresholding, thresholding_max_val)
    blend = common.masked_blend_fn(mask, x0, schedule.sqrt_alphas_cumprod,
                                   schedule.sqrt_one_minus_alphas_cumprod, generator)
    n_t = schedule.num_timesteps
    x = x_T.float()
    m_0 = f(x, tab["model_t"][0], tab["node_alpha"][0], tab["node_sigma"][0])
    m_1 = m_2 = torch.zeros_like(m_0)
    for i in range(steps):
        ratio, c0, cd1, cd2, r0, r1, o2, o3 = (
            float(tab[k][i]) for k in ("ratio", "c0", "cd1", "cd2", "r0", "r1", "o2", "o3"))
        d1_0 = (m_0 - m_1) / r0
        d1_1 = (m_1 - m_2) / r1
        d1 = d1_0 + (r0 / (r0 + r1)) * (d1_0 - d1_1)
        d2 = (d1_0 - d1_1) / (r0 + r1)
        x = (ratio * x - c0 * m_0
             - 0.5 * c0 * (o2 * (1.0 - o3)) * d1_0          # 2M correction
             + o3 * (cd1 * d1 - cd2 * d2))                  # 3M correction
        if mask is not None:
            x = blend(x, min(max(int(tab["model_t"][i + 1]), 0), n_t - 1))
        m_next = (f(x, tab["model_t"][i + 1], tab["node_alpha"][i + 1],
                    tab["node_sigma"][i + 1])
                  if i < steps - 1 else m_0)
        m_0, m_1, m_2 = m_next, m_0, m_1
    return x


# ---- singlestep ---------------------------------------------------------


def _orders_for_singlestep(steps: int, order: int) -> list:
    """Group sizes per outer step (the reference's
    get_orders_and_timesteps_for_singlestep_solver)."""
    if order == 3:
        k = steps // 3 + 1
        if steps % 3 == 0:
            return [3] * (k - 2) + [2, 1]
        if steps % 3 == 1:
            return [3] * (k - 1) + [1]
        return [3] * (k - 1) + [2]
    if order == 2:
        return [2] * (steps // 2) + ([1] if steps % 2 else [])
    if order == 1:
        return [1] * steps
    raise NotImplementedError("singlestep order must be 1, 2 or 3")


def build_singlestep_groups(schedule: DiffusionSchedule, steps: int, order: int = 2,
                            skip_type: str = "time_uniform",
                            prediction: str = "data") -> list:
    """Host-side coefficient dicts, one per group of `order` sequential model
    evals at intermediate lambda nodes: eval nodes (ev_mt, ev_a, ev_s) and
    the combine scalars of the order-k update; r1/r2 from uniform inner
    time splits."""
    n, t_disc, log_alpha_disc = _discrete(schedule)
    orders = _orders_for_singlestep(steps, order)
    t_seq = _time_nodes(steps, t_T=1.0, t_0=1.0 / n, skip_type=skip_type)
    t_outer = t_seq[np.cumsum([0] + orders)]
    groups = []
    for g, k in enumerate(orders):
        s, t = t_outer[g], t_outer[g + 1]
        inner = _time_nodes(k, t_T=s, t_0=t, skip_type=skip_type)
        a, sg, lam = _marginals(inner, t_disc, log_alpha_disc)
        h = lam[-1] - lam[0]
        co = dict(order=k, ev_mt=[(ti - 1.0 / n) * 1000.0 for ti in inner[:k]],
                  ev_a=list(a[:k]), ev_s=list(sg[:k]),
                  t_int=int(np.clip((t - 1.0 / n) * 1000.0, 0, n - 1)))
        if prediction == "data":
            phi_1 = np.expm1(-h)
            co["at"] = sg[-1] / sg[0]
            co["bt"] = -a[-1] * phi_1
            if k >= 2:
                r1 = (lam[1] - lam[0]) / h
                co["a1"] = sg[1] / sg[0]
                co["b1"] = -a[1] * np.expm1(-r1 * h)
                if k == 2:
                    co["ct"] = -(0.5 / r1) * a[-1] * phi_1
                else:
                    r2 = (lam[2] - lam[0]) / h
                    phi_22 = np.expm1(-r2 * h) / (r2 * h) + 1.0
                    phi_2 = phi_1 / h + 1.0
                    co["a2"] = sg[2] / sg[0]
                    co["b2"] = -a[2] * np.expm1(-r2 * h)
                    co["c2"] = (r2 / r1) * a[2] * phi_22
                    co["ct"] = (1.0 / r2) * a[-1] * phi_2
        else:
            phi_1 = np.expm1(h)
            co["at"] = a[-1] / a[0]
            co["bt"] = -sg[-1] * phi_1
            if k >= 2:
                r1 = (lam[1] - lam[0]) / h
                co["a1"] = a[1] / a[0]
                co["b1"] = -sg[1] * np.expm1(r1 * h)
                if k == 2:
                    co["ct"] = -(0.5 / r1) * sg[-1] * phi_1
                else:
                    r2 = (lam[2] - lam[0]) / h
                    phi_22 = np.expm1(r2 * h) / (r2 * h) - 1.0
                    phi_2 = phi_1 / h - 1.0
                    co["a2"] = a[2] / a[0]
                    co["b2"] = -sg[2] * np.expm1(r2 * h)
                    co["c2"] = -(r2 / r1) * sg[2] * phi_22
                    co["ct"] = -(1.0 / r2) * sg[-1] * phi_2
        groups.append(co)
    return groups


def sample_singlestep(eps_fn: common.EpsFn, x_T: torch.Tensor,
                      schedule: DiffusionSchedule, steps: int = 15, order: int = 2,
                      skip_type: str = "time_uniform",
                      prediction: str = "data", thresholding: bool = False,
                      thresholding_max_val: float = 1.0,
                      mask: Optional[torch.Tensor] = None,
                      x0: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """DPM-Solver singlestep: one update per group, `steps` model evals.
    With `mask`/`x0`, each group's update blends at the group's end
    timestep (`t_int`)."""
    _check_thresholding(thresholding, prediction)
    groups = build_singlestep_groups(schedule, steps, order, skip_type, prediction)
    f = _model_fn(eps_fn, prediction, thresholding, thresholding_max_val)
    blend = common.masked_blend_fn(mask, x0, schedule.sqrt_alphas_cumprod,
                                   schedule.sqrt_one_minus_alphas_cumprod, generator)
    x = x_T.float()
    for co in groups:
        k = co["order"]
        c = {name: float(val) for name, val in co.items()
             if name not in ("order", "ev_mt", "ev_a", "ev_s", "t_int")}
        m_s = f(x, co["ev_mt"][0], co["ev_a"][0], co["ev_s"][0])
        if k == 1:
            x = c["at"] * x + c["bt"] * m_s
        else:
            x_s1 = c["a1"] * x + c["b1"] * m_s
            m_s1 = f(x_s1, co["ev_mt"][1], co["ev_a"][1], co["ev_s"][1])
            if k == 2:
                x = c["at"] * x + c["bt"] * m_s + c["ct"] * (m_s1 - m_s)
            else:
                x_s2 = c["a2"] * x + c["b2"] * m_s + c["c2"] * (m_s1 - m_s)
                m_s2 = f(x_s2, co["ev_mt"][2], co["ev_a"][2], co["ev_s"][2])
                x = c["at"] * x + c["bt"] * m_s + c["ct"] * (m_s2 - m_s)
        if mask is not None:
            x = blend(x, co["t_int"])
    return x


# ---- adaptive -----------------------------------------------------------


def _interp32(x, xp: np.ndarray, fp: np.ndarray) -> np.float32:
    """jnp.interp at one point, in fp32 like the JAX solver's on-device
    schedule interpolation: constant outside [xp[0], xp[-1]]."""
    x = np.float32(x)
    i = int(np.clip(np.searchsorted(xp, x, side="right"), 1, len(xp) - 1))
    dx = xp[i] - xp[i - 1]
    if abs(dx) <= np.spacing(np.finfo(np.float32).eps):
        f = fp[i - 1]
    else:
        f = fp[i - 1] + ((x - xp[i - 1]) / dx) * (fp[i] - fp[i - 1])
    if x < xp[0]:
        f = fp[0]
    if x > xp[-1]:
        f = fp[-1]
    return np.float32(f)


def sample_adaptive(eps_fn: common.EpsFn, x_T: torch.Tensor,
                    schedule: DiffusionSchedule, order: int = 3, atol: float = 0.0078,
                    rtol: float = 0.05, h_init: float = 0.05, theta: float = 0.9,
                    t_err: float = 1e-5, max_nfe: int = 1000,
                    prediction: str = "data", group=None) -> torch.Tensor:
    """Adaptive step-size DPM-Solver with an embedded (order-1, order) pair
    and step doubling: accept when the sample-wise RMS of
    (x_high - x_low) / delta is <= 1, then
    h <- min(theta * h * E^(-1/order), lambda_0 - lambda_s).

    The step size, lambda and time are fp32 host scalars (the schedule is
    interpolated in fp32, as the JAX solver does on device). The loop syncs
    with the host once per iteration: reading the error norm E, which
    decides acceptance and the next step size.

    E is the max over the whole batch of the rows' RMS, each row reduced on
    its own. Where the batch is split over the ranks of a process `group`
    (each rank passing its own rows), E is also taken as the max over the
    group (one all-reduce an iteration), so every rank takes the steps, the
    decisions and the model calls of the call on the whole batch; None (one
    process) issues no collective."""
    if order not in (2, 3):
        raise NotImplementedError("adaptive order must be 2 or 3")
    if prediction not in ("data", "noise"):
        raise NotImplementedError("prediction must be 'data' or 'noise'")
    n, t_disc, log_alpha_disc = _discrete(schedule)
    sigma_disc = np.sqrt(np.maximum(1.0 - np.exp(2.0 * log_alpha_disc), 1e-20))
    lam_disc = log_alpha_disc - np.log(sigma_disc)
    t_tab, la_tab = _f32(t_disc), _f32(log_alpha_disc)
    lam_asc, t_desc = _f32(lam_disc[::-1]), _f32(t_disc[::-1])
    one, f32 = np.float32(1.0), np.float32

    def marginals(t):
        la = _interp32(t, t_tab, la_tab)
        sigma = np.sqrt(np.maximum(one - np.exp(f32(2.0) * la), f32(1e-20)))
        return np.exp(la), sigma, la - np.log(sigma)

    def t_of_lam(lam):
        return _interp32(lam, lam_asc, t_desc)

    lam_T = marginals(f32(1.0))[2]
    lam_0 = marginals(f32(1.0 / n))[2]

    def data_pred(x, t):
        a, s, _ = marginals(t)
        mt = (t - f32(1.0 / n)) * f32(1000.0)
        eps = eps_fn(x, common.broadcast_time(mt, x.device)).float()
        return eps if prediction == "noise" else (x - float(s) * eps) / float(a)

    def pair_update(x, t_s, t_t):
        """(x_lower of order-1 [order 2] / order-2 [order 3], x_higher)."""
        a_s, s_s, lam_s = marginals(t_s)
        a_t, s_t, lam_t = marginals(t_t)
        h = lam_t - lam_s
        m_s = data_pred(x, t_s)
        data = prediction == "data"
        phi_1 = np.expm1(-h) if data else np.expm1(h)
        carry_t, base_t = (s_t / s_s, a_t * phi_1) if data else (a_t / a_s, s_t * phi_1)

        def inner(r):
            """Time, alpha, sigma and the first-order state at lambda_s + r*h."""
            t_r = t_of_lam(lam_s + r * h)
            a_r, s_r, _ = marginals(t_r)
            if data:
                x_r = float(s_r / s_s) * x - float(a_r * np.expm1(-r * h)) * m_s
            else:
                x_r = float(a_r / a_s) * x - float(s_r * np.expm1(r * h)) * m_s
            return t_r, a_r, s_r, x_r

        if order == 2:
            x_low = float(carry_t) * x - float(base_t) * m_s          # first update
            r1 = f32(0.5)
            t_s1, _, _, x_s1 = inner(r1)
            m_s1 = data_pred(x_s1, t_s1)
            x_high = x_low - float((f32(0.5) / r1) * base_t) * (m_s1 - m_s)
            return x_low, x_high
        r1, r2 = f32(1.0 / 3.0), f32(2.0 / 3.0)
        t_s1, _, _, x_s1 = inner(r1)
        t_s2, a_s2, s_s2, x_s2 = inner(r2)
        m_s1 = data_pred(x_s1, t_s1)
        x_low = (float(carry_t) * x - float(base_t) * m_s           # second update
                 - float((f32(0.5) / r1) * base_t) * (m_s1 - m_s))
        if data:
            phi_22 = np.expm1(-r2 * h) / (r2 * h) + one
            phi_2 = phi_1 / h + one
            x_s2 = x_s2 + float((r2 / r1) * a_s2 * phi_22) * (m_s1 - m_s)
            x_high_c = float((one / r2) * a_t * phi_2)
        else:
            phi_22 = np.expm1(r2 * h) / (r2 * h) - one
            phi_2 = phi_1 / h - one
            x_s2 = x_s2 - float((r2 / r1) * s_s2 * phi_22) * (m_s1 - m_s)
            x_high_c = -float((one / r2) * s_t * phi_2)
        m_s2 = data_pred(x_s2, t_s2)
        x_high = (float(carry_t) * x - float(base_t) * m_s
                  + x_high_c * (m_s2 - m_s))
        return x_low, x_high

    x = x_prev = x_T.float()
    lam_s, h, nfe = lam_T, f32(h_init), 0
    while lam_s < lam_0 - f32(t_err) and nfe < max_nfe:
        t_s, t_t = t_of_lam(lam_s), t_of_lam(lam_s + h)
        x_low, x_high = pair_update(x, t_s, t_t)
        delta = torch.clamp(rtol * torch.maximum(x_low.abs(), x_prev.abs()), min=atol)
        err = (x_high - x_low) / delta
        # each row's RMS by a reduction of its own: one over the whole batch
        # would sum a row in another order at another batch size (on the card)
        rows = err.reshape(err.shape[0], -1)
        e = torch.stack([r.pow(2).mean().sqrt() for r in rows]).max()
        if group is not None:
            import torch.distributed as dist

            dist.all_reduce(e, op=dist.ReduceOp.MAX, group=group)
        e = f32(e.item())
        if e <= one:                                  # the host sync of the step
            x, x_prev = x_high, x_low
            lam_s = marginals(t_t)[2]
        h = min(f32(theta) * h * max(e, f32(1e-10)) ** f32(-1.0 / order), lam_0 - lam_s)
        nfe += order
    return x
