"""Diffusion samplers (port of gcd_tpu/diffusion/sampling.py).

Each JAX lax.scan becomes a Python loop over the numpy sigma ladder. Every
per-step scalar that JAX computes on the device (churn's sigma_hat, the
ancestral sigma_down / sigma_up, the DPM++ multipliers, the LMS
coefficients) is a function of the ladder, so `plan` computes it on the
host in float32 with JAX's formula, and the branches JAX takes with
lax.cond / jnp.where (Heun's last step, DPM++ 2S's Euler-only step, DPM++
2M's first and last steps) are Python `if`s on those numbers: no device
sync, and only the branch taken is computed.

Noise: the initial unit noise is passed in, and so is the per-step noise
of the samplers that draw it at every step (`needs_step_noise`: EDMSampler
with s_churn > 0, the two ancestral samplers): one tensor (steps, *x.shape),
row i belonging to step i, as JAX's `split(key, steps)[i]` does (JAX draws
a row for every step, the final one included, even where it is masked out).

With a `guidance_interval` (lo, hi), each denoiser evaluation applies CFG
when its own sigma (churn's sigma_hat, Heun's next sigma, DPM++ 2S's
exp(-s)) is in [lo, hi] and runs the bare conditional batch otherwise,
compared in float32 as JAX's `denoise` compares it.

Every loop takes its denoiser evaluations through one callable,
`evaluate(x, sigma, guided) -> denoised` (sigma the (N,) fp32 rows of x):
`__call__` builds it over the eager denoiser (`evaluator`), and an exported
sampler (engine/export.py) over its exported evaluation programs, so each
sampler's update has one definition, `run`, that both execute. An exported
sampler rebuilds the sampler from its record (`sampler_record` /
`sampler_from_record`): its class, its own scalars, the ladder and the
host plan, float32 values carried through JSON exactly.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gcd_tpu_torch.diffusion.denoiser import _append_dims
from gcd_tpu_torch.utils.config import get_obj_from_str, instantiate_from_config

DEFAULT_GUIDER = {"target": "sgm.modules.diffusionmodules.guiders.IdentityGuider"}
SAMPLING = "sgm.modules.diffusionmodules.sampling."  # the samplers' config names
f32 = np.float32
TINY = f32(1e-14)  # JAX's "this sigma is 0" threshold
# evaluate(x, sigma, guided) -> denoised, sigma the (N,) fp32 rows of x.
Evaluate = Callable[[torch.Tensor, torch.Tensor, bool], torch.Tensor]


def get_ancestral_step(sigma_from: np.float32, sigma_to: np.float32, eta: float = 1.0):
    """(sigma_down, sigma_up) of an ancestral step, float32 (JAX's
    get_ancestral_step on host scalars)."""
    if not eta:
        return sigma_to, f32(0.0)
    sigma_up = np.minimum(sigma_to, f32(eta) * np.sqrt(
        sigma_to * sigma_to * (sigma_from * sigma_from - sigma_to * sigma_to)
        / (sigma_from * sigma_from)))
    return np.sqrt(sigma_to * sigma_to - sigma_up * sigma_up), sigma_up


class BaseDiffusionSampler:
    """The ladder, the guider and the per-evaluation guidance decision.

    guidance_interval=(lo, hi) applies CFG only at the evaluations whose
    sigma is in [lo, hi] and runs the bare conditional branch, at half the
    UNet batch, at the others (Kynkaanniemi et al. 2024, "Applying Guidance
    in a Limited Interval", arXiv:2404.07724). None, the default, is exact
    CFG at every evaluation, the reference protocol. A sampler with no
    guider_config gets IdentityGuider, as JAX's DEFAULT_GUIDER."""

    needs_step_noise = False
    # The sampler's own settings that `loop` reads (an exported sampler's
    # record carries them).
    SCALARS: Tuple[str, ...] = ("guidance_interval",)

    def __init__(self, discretization_config: Dict, num_steps: Optional[int] = None,
                 guider_config: Optional[Dict] = None, verbose: bool = False,
                 device: Optional[str] = None,
                 guidance_interval: Optional[Sequence[float]] = None):
        # verbose and device: accepted for config parity.
        self.num_steps = num_steps
        self.discretization = instantiate_from_config(discretization_config)
        self.guider = instantiate_from_config(guider_config or DEFAULT_GUIDER)
        self.guidance_interval = None
        if guidance_interval is not None:
            lo, hi = (float(v) for v in guidance_interval)
            if not lo <= hi:
                raise ValueError(f"guidance_interval ({lo}, {hi}): lo must not exceed hi")
            self.guidance_interval = (lo, hi)

    def sigmas(self, num_steps: Optional[int] = None) -> np.ndarray:
        """The ladder, float32, with the final 0."""
        return self.discretization(num_steps or self.num_steps)

    def plan(self, sigmas: np.ndarray) -> List[Dict]:
        """Per step, the host scalars of its update and "evals", the float32
        sigma of each of its denoiser evaluations."""
        raise NotImplementedError

    def guided(self, sigma: np.float32) -> bool:
        """Whether an evaluation at `sigma` applies CFG (float32 compare)."""
        if self.guidance_interval is None:
            return True
        lo, hi = (f32(v) for v in self.guidance_interval)
        return bool(lo <= f32(sigma) <= hi)

    def guided_evaluations(self, num_steps: Optional[int] = None) -> List[List[bool]]:
        """Per step, whether each of its evaluations applies CFG."""
        return [[self.guided(s) for s in step["evals"]]
                for step in self.plan(self.sigmas(num_steps))]

    def guided_steps(self, num_steps: Optional[int] = None) -> List[bool]:
        """Per step, whether its first evaluation applies CFG."""
        return [g[0] for g in self.guided_evaluations(num_steps)]

    def denoise(self, denoiser: Callable, x: torch.Tensor, sigma: torch.Tensor, cond: Dict,
                uc: Dict, guided: bool) -> torch.Tensor:
        """`denoiser(x, sigma, cond) -> denoised` through the guider (on the
        CFG-doubled batch) when `guided`, on x's own batch otherwise."""
        if guided:
            x_in, s_in, c_in = self.guider.prepare_inputs(x, sigma, cond, uc)
            return self.guider(denoiser(x_in, s_in, c_in))
        return denoiser(x, sigma, cond)

    def evaluator(self, denoiser: Callable, cond: Dict, uc: Dict) -> Evaluate:
        """`evaluate(x, sigma, guided)`: `denoise` over `denoiser` with cond
        and uc."""
        return lambda x, sigma, guided: self.denoise(denoiser, x, sigma, cond, uc, guided)

    def evaluate_at(self, evaluate: Evaluate, x: torch.Tensor, sigma: np.float32
                    ) -> torch.Tensor:
        """`evaluate` at the host sigma `sigma`, guided as `guided` decides."""
        sig = torch.full((x.shape[0],), float(sigma), dtype=torch.float32, device=x.device)
        return evaluate(x, sig, self.guided(sigma))

    def __call__(self, denoiser: Callable, x: torch.Tensor, cond: Dict,
                 uc: Optional[Dict] = None, num_steps: Optional[int] = None,
                 step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sample from the initial unit-variance noise x; `step_noise`
        (steps, *x.shape) for a sampler that `needs_step_noise`."""
        sigmas = self.sigmas(num_steps)
        return self.run(self.evaluator(denoiser, cond, cond if uc is None else uc), x, sigmas,
                        self.plan(sigmas), step_noise)

    def run(self, evaluate: Evaluate, x: torch.Tensor, sigmas: np.ndarray, plan: List[Dict],
            step_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The sampler over the ladder `sigmas` and its `plan` from the unit
        noise x, its evaluations through `evaluate`: what `__call__` and an
        exported sampler run."""
        if self.needs_step_noise:
            want = (len(sigmas) - 1, *x.shape)
            if step_noise is None or tuple(step_noise.shape) != want:
                raise ValueError(f"{type(self).__name__} draws noise at every step: "
                                 f"step_noise must be {want}, got "
                                 f"{None if step_noise is None else tuple(step_noise.shape)}")
        x = x * float(np.sqrt(1.0 + sigmas[0] ** 2))
        return self.loop(evaluate, x, sigmas, plan, step_noise)

    def loop(self, evaluate: Evaluate, x: torch.Tensor, sigmas: np.ndarray, plan: List[Dict],
             step_noise: Optional[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError


class EDMSampler(BaseDiffusionSampler):
    """Euler over the EDM ladder, with optional churn: at the steps whose
    sigma is in [s_tmin, s_tmax], x is first noised up to sigma_hat =
    sigma * (1 + gamma), gamma = min(s_churn / steps, sqrt(2) - 1)."""

    SCALARS = BaseDiffusionSampler.SCALARS + ("s_churn", "s_tmin", "s_tmax", "s_noise")

    def __init__(self, s_churn: float = 0.0, s_tmin: float = 0.0,
                 s_tmax: float = float("inf"), s_noise: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.s_churn = float(s_churn)
        self.s_tmin = float(s_tmin)
        self.s_tmax = float(s_tmax)
        self.s_noise = float(s_noise)

    @property
    def needs_step_noise(self) -> bool:
        return self.s_churn > 0.0

    def corrects(self, next_sigma: np.float32) -> bool:
        """Whether a step to `next_sigma` evaluates a correction (Heun)."""
        return False

    def plan(self, sigmas: np.ndarray) -> List[Dict]:
        steps = len(sigmas) - 1
        out = []
        for i in range(steps):
            sigma, next_sigma = sigmas[i], sigmas[i + 1]
            gamma = f32(0.0)
            if self.s_tmin <= sigma <= self.s_tmax:
                gamma = f32(min(self.s_churn / steps, 2 ** 0.5 - 1))
            sigma_hat = sigma * (gamma + f32(1.0))
            bump = np.sqrt(np.maximum(sigma_hat * sigma_hat - sigma * sigma, f32(0.0)))
            out.append({"sigma_hat": sigma_hat, "bump": bump,
                        "evals": [sigma_hat] + [next_sigma] * self.corrects(next_sigma)})
        return out

    def euler(self, evaluate: Evaluate, x: torch.Tensor, sigma: torch.Tensor,
              next_sigma: torch.Tensor, guided: bool):
        """(x at next_sigma, d, dt) of one Euler step from the 0-d fp32
        tensor `sigma` to `next_sigma`."""
        s_in = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
        sig = s_in * sigma
        denoised = evaluate(x, sig, guided)
        d = (x - denoised) / _append_dims(sig, x.dim())
        dt = _append_dims(s_in * next_sigma - sig, x.dim())
        return x + dt * d, d, dt

    def step(self, evaluate: Evaluate, x: torch.Tensor, sigma: torch.Tensor,
             next_sigma: torch.Tensor, guided: bool) -> torch.Tensor:
        """One Euler step of x from `sigma` to `next_sigma`, 0-d fp32 tensors
        (the loop's and an exported step program's one definition), its
        evaluation `evaluate(x, sigma rows, guided)`."""
        return self.euler(evaluate, x, sigma, next_sigma, guided)[0]

    def loop(self, evaluate, x, sigmas, plan, step_noise):
        ladder = torch.from_numpy(sigmas).to(x.device)
        if self.needs_step_noise:
            hats = torch.from_numpy(np.array([p["sigma_hat"] for p in plan])).to(x.device)
        for i, p in enumerate(plan):
            sigma_hat = ladder[i]
            if p["bump"] > 0:  # churn: x noised up to sigma_hat
                noise = step_noise[i] if self.s_noise == 1.0 else step_noise[i] * self.s_noise
                x = x + noise * float(p["bump"])
                sigma_hat = hats[i]
            guided = [self.guided(s) for s in p["evals"]]
            euler, d, dt = self.euler(evaluate, x, sigma_hat, ladder[i + 1], guided[0])
            if len(guided) == 1:
                x = euler
                continue
            sig = torch.ones(x.shape[0], dtype=torch.float32, device=x.device) * ladder[i + 1]
            denoised = evaluate(euler, sig, guided[1])
            d_new = (euler - denoised) / _append_dims(sig, x.dim())
            x = x + (d + d_new) / 2.0 * dt
        return x


class EulerEDMSampler(EDMSampler):
    """Plain Euler over the EDM sigma ladder, the sampler of every released
    GCD model."""


class HeunEDMSampler(EDMSampler):
    """Euler with Heun's second-order correction: a second evaluation at
    the next sigma, skipped on the final step to 0."""

    def corrects(self, next_sigma: np.float32) -> bool:
        return bool(next_sigma > TINY)


class AncestralSampler(BaseDiffusionSampler):
    """An ancestral step goes down to sigma_down and adds fresh noise of
    sigma_up (none on the final step to 0)."""

    needs_step_noise = True
    SCALARS = BaseDiffusionSampler.SCALARS + ("eta", "s_noise")

    def __init__(self, eta: float = 1.0, s_noise: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        self.eta = float(eta)
        self.s_noise = float(s_noise)

    def plan(self, sigmas: np.ndarray) -> List[Dict]:
        out = []
        for i in range(len(sigmas) - 1):
            sigma_down, sigma_up = get_ancestral_step(sigmas[i], sigmas[i + 1], self.eta)
            out.append({"sigma": sigmas[i], "sigma_down": sigma_down, "sigma_up": sigma_up,
                        "add_noise": bool(sigmas[i + 1] > 0), "evals": [sigmas[i]]})
        return out

    def ancestral_step(self, x: torch.Tensor, p: Dict, noise: torch.Tensor) -> torch.Tensor:
        if not p["add_noise"]:
            return x
        if self.s_noise != 1.0:
            noise = noise * self.s_noise
        return x + noise * float(p["sigma_up"])

    @staticmethod
    def ancestral_euler(x: torch.Tensor, denoised: torch.Tensor, p: Dict) -> torch.Tensor:
        d = (x - denoised) / float(p["sigma"])
        return x + float(p["sigma_down"] - p["sigma"]) * d


class EulerAncestralSampler(AncestralSampler):
    def loop(self, evaluate, x, sigmas, plan, step_noise):
        for i, p in enumerate(plan):
            denoised = self.evaluate_at(evaluate, x, p["sigma"])
            x = self.ancestral_step(self.ancestral_euler(x, denoised, p), p, step_noise[i])
        return x


class DPMPP2SAncestralSampler(AncestralSampler):
    """DPM-Solver++(2S) ancestral: a midpoint evaluation at exp(-s) between
    sigma and sigma_down, Euler alone where sigma_down is 0."""

    def plan(self, sigmas):
        out = super().plan(sigmas)
        for p in out:
            if p["sigma_down"] < TINY:
                continue
            t = -np.log(p["sigma"])
            t_next = -np.log(np.maximum(p["sigma_down"], f32(1e-10)))
            h = t_next - t
            s = t + f32(0.5) * h
            p["mults"] = (np.exp(-s) / np.exp(-t), np.expm1(f32(-0.5) * h),
                          np.exp(-t_next) / np.exp(-t), np.expm1(-h))
            p["evals"].append(np.exp(-s))
        return out

    def loop(self, evaluate, x, sigmas, plan, step_noise):
        for i, p in enumerate(plan):
            denoised = self.evaluate_at(evaluate, x, p["sigma"])
            if "mults" not in p:
                x = self.ancestral_euler(x, denoised, p)
            else:
                mult1, mult2, mult3, mult4 = (float(m) for m in p["mults"])
                x2 = mult1 * x - mult2 * denoised
                denoised2 = self.evaluate_at(evaluate, x2, p["evals"][1])
                x = mult3 * x - mult4 * denoised2
            x = self.ancestral_step(x, p, step_noise[i])
        return x


class DPMPP2MSampler(BaseDiffusionSampler):
    """DPM-Solver++(2M): the second-order multistep update from the last
    step's denoised, the first-order one at the first and final steps."""

    def plan(self, sigmas):
        out = []
        for i in range(len(sigmas) - 1):
            sigma, next_sigma = sigmas[i], sigmas[i + 1]
            t = -np.log(sigma)
            t_next = -np.log(np.maximum(next_sigma, f32(1e-10)))
            h = t_next - t
            p = {"evals": [sigma], "mult1": np.exp(-t_next) / np.exp(-t),
                 "mult2": np.expm1(-h), "standard": i == 0 or bool(next_sigma < TINY)}
            if not p["standard"]:
                t_prev = -np.log(sigmas[i - 1])
                r = (t - t_prev) / h
                p["mult3"] = f32(1.0) + f32(1.0) / (f32(2.0) * r)
                p["mult4"] = f32(1.0) / (f32(2.0) * r)
            out.append(p)
        return out

    def loop(self, evaluate, x, sigmas, plan, step_noise):
        old_denoised = None
        for p in plan:
            denoised = self.evaluate_at(evaluate, x, p["evals"][0])
            target = denoised
            if not p["standard"]:
                target = float(p["mult3"]) * denoised - float(p["mult4"]) * old_denoised
            x = float(p["mult1"]) * x - float(p["mult2"]) * target
            old_denoised = denoised
        return x


class LinearMultistepSampler(BaseDiffusionSampler):
    """Linear multistep (LMS) of `order`: each step adds the newest
    derivatives weighted by the integrals of their Lagrange polynomials
    over the step, a table computed on the host with scipy."""

    SCALARS = BaseDiffusionSampler.SCALARS + ("order",)

    def __init__(self, order: int = 4, **kwargs):
        super().__init__(**kwargs)
        self.order = int(order)

    @staticmethod
    def _lms_coeff(order, t, i, j):
        from scipy import integrate

        def fn(tau):
            prod = 1.0
            for k in range(order):
                if j == k:
                    continue
                prod *= (tau - t[i - k]) / (t[i - j] - t[i - k])
            return prod

        return integrate.quad(fn, t[i], t[i + 1], epsrel=1e-4)[0]

    def plan(self, sigmas):
        out = []
        for i in range(len(sigmas) - 1):
            cur_order = min(i + 1, self.order)
            coeffs = np.array([self._lms_coeff(cur_order, sigmas, i, j)
                               for j in range(cur_order)], np.float32)
            out.append({"evals": [sigmas[i]], "coeffs": coeffs})
        return out

    def loop(self, evaluate, x, sigmas, plan, step_noise):
        ds: List[torch.Tensor] = []  # newest first
        for p in plan:
            sigma = p["evals"][0]
            denoised = self.evaluate_at(evaluate, x, sigma)
            ds = [(x - denoised) / float(sigma)] + ds[:self.order - 1]
            update = float(p["coeffs"][0]) * ds[0]
            for c, d in zip(p["coeffs"][1:], ds[1:]):
                update = update + float(c) * d
            x = x + update
        return x


def _to_json(v: Any) -> Any:
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (np.ndarray, list, tuple)):
        return [float(e) for e in v]
    return float(v)


def _from_json(v: Any) -> Any:
    if isinstance(v, bool):
        return v
    if isinstance(v, list):
        return np.array(v, dtype=np.float32)
    return f32(v)


def sampler_record(sampler: BaseDiffusionSampler, num_steps: Optional[int] = None) -> Dict:
    """What running `sampler` over `num_steps` needs beside its evaluations,
    as JSON-ready data: its config name, its own scalars (SCALARS), the
    ladder, the host plan (float32 values as the doubles that hold them
    exactly) and whether it draws per-step noise."""
    sigmas = sampler.sigmas(num_steps)
    scalars = {}
    for k in sampler.SCALARS:
        v = getattr(sampler, k)
        scalars[k] = list(v) if isinstance(v, tuple) else v
    return {"target": SAMPLING + type(sampler).__name__, "scalars": scalars,
            "sigmas": [float(s) for s in sigmas],
            "plan": [{k: _to_json(v) for k, v in p.items()} for p in sampler.plan(sigmas)],
            "step_noise": bool(sampler.needs_step_noise)}


def sampler_from_record(record: Dict) -> Tuple[BaseDiffusionSampler, np.ndarray, List[Dict]]:
    """(sampler, ladder, plan) of a `sampler_record`, for `sampler.run`:
    the sampler holds its scalars and no discretization or guider (the
    evaluations carry the guider), so nothing of its config is needed."""
    cls = get_obj_from_str(record["target"])
    sampler = cls.__new__(cls)
    sampler.num_steps = sampler.discretization = sampler.guider = None
    for k, v in record["scalars"].items():
        setattr(sampler, k, tuple(v) if isinstance(v, list) else v)
    plan = [{k: _from_json(v) for k, v in p.items()} for p in record["plan"]]
    return sampler, np.array(record["sigmas"], dtype=np.float32), plan
