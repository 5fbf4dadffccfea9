"""The exported sampler (port of gcd_tpu/engine/export.py).

    blob = export_sampler(engine, engine.state_dict(), batch, num_steps=25)
    open("sampler.gcdexp", "wb").write(blob)
    # serving host: the port's op library (import gcd_tpu_torch.ops), the
    # weights, and no model construction or config
    sample = load_sampler(open("sampler.gcdexp", "rb").read())
    out = sample(params, arrays, generator)   # dict, as engine.sample_video

The artifact is a zip of torch.export programs and a JSON header. Every
artifact has
  cond    the conditioner: the batch's arrays -> c and uc (channels-first),
          cond_video, and gt_video when the batch has "jpg";
  decode  the latents -> frames in [0, 1] (in decoding_t's chunks).
An EulerEDMSampler without churn exports whole steps:
  step    one Euler step (EulerEDMSampler.step) with CFG: x, sigma and
          next_sigma (0-d fp32 tensors), the indicator, c and uc -> x at
          next_sigma;
  plain   the same step without CFG, on the conditional half alone, for the
          steps outside a guidance_interval (only when there are such steps);
and its header holds the sigma ladder, each step's guided flag and the
initial noise scale. Every other sampler (EDMSampler with churn, Heun,
Euler-ancestral, DPM++ 2S / 2M, LMS) exports its evaluation:
  eval        the denoiser with CFG: x, sigma (its (B*T,) fp32 rows), the
              indicator, c and uc -> denoised;
  eval_plain  the same without CFG, for the evaluations outside a
              guidance_interval (only when there are such evaluations);
and its header adds the sampler's record (diffusion/sampling.py
sampler_record: its config name, its own scalars, the ladder, the host
plan, whether it draws per-step noise). The loader runs that sampler's own
`run` over the plan with the exported evaluations, so the update has one
definition, the one engine.sample_video runs. Either way the UNet is
traced at most twice, guided and plain, with its sigma in a tensor; the
header also holds each program's parameter names and input specs.

Weights are inputs of every program: each program takes its engine
submodule's parameters through torch.func.functional_call, and none is
lifted into the artifact, so the blob is megabytes (gcd_tpu's export keeps
the weights out the same way). `params` is the engine's state dict in the
reference key space (`engine.state_dict()`, or a bundle's engine's).

Shapes are fixed at export: one artifact per (B, T, H, W); `sample` raises
on an array of another shape or dtype. The kernel switches in force at
export are baked in, as JAX bakes its flags at trace time: with a switch on
the program calls the kernel's op (`gcd::...`, ops/library.py), with it off
the plain version. Tensors a forward makes with `device=x.device` (the
guider's scales, the CLIP resize matrices) are recorded with their device,
so an artifact runs on the device it was exported on. torch.export's format
is its torch version's: export and load with one version.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from gcd_tpu_torch.diffusion.sampling import EulerEDMSampler, sampler_from_record, sampler_record
from gcd_tpu_torch.engine.engine import UC_ZERO_KEYS, _channels_first, _unit_interval

FORMAT = "gcd_tpu_torch.sampler/1"


def _split_batch(batch: Dict) -> Tuple[Dict, Dict]:
    """(the batch's tensors, its other entries: gcd_tpu export.py's
    `_split_batch`)."""
    arrays = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}
    return arrays, {k: v for k, v in batch.items() if k not in arrays}


def initial_latents(noise: torch.Tensor, scale: float) -> torch.Tensor:
    """The sampler's starting x from the unit noise (B*T, h, w, 4):
    channels-first fp32 times sqrt(1 + sigma_0^2), as sample_latents and
    EulerEDMSampler make it."""
    return _channels_first(noise).float() * scale


class _Conditioner(nn.Module):
    def __init__(self, engine, keys: Sequence[str], static: Dict, cond_keys: Sequence[str]):
        super().__init__()
        self.conditioner = engine.conditioner
        self.__dict__["engine"] = engine
        self.keys, self.static, self.cond_keys = list(keys), dict(static), list(cond_keys)

    def forward(self, *arrays):
        batch = dict(zip(self.keys, arrays), **self.static)
        c, uc = self.engine.get_unconditional_conditioning(batch, UC_ZERO_KEYS)
        out = [_channels_first(c[k]) for k in self.cond_keys]
        out += [_channels_first(uc[k]) for k in self.cond_keys]
        out.append(_unit_interval(batch["cond_frames"]))
        if "jpg" in batch:
            out.append(_unit_interval(batch["jpg"]))
        return tuple(out)


class _Evaluation(nn.Module):
    """The sampler's evaluation at (x, sigma rows), guided or not:
    forward(x, sigma, image_only_indicator, *c[, *uc]) -> denoised."""

    def __init__(self, engine, guided: bool, cond_keys: Sequence[str]):
        super().__init__()
        self.model = engine.model
        self.__dict__["engine"] = engine
        self.guided, self.cond_keys = guided, list(cond_keys)

    def evaluate(self, image_only_indicator, conds):
        n = len(self.cond_keys)
        c = dict(zip(self.cond_keys, conds[:n]))
        uc = dict(zip(self.cond_keys, conds[n:])) if self.guided else c
        engine = self.engine
        return engine.sampler.evaluator(engine.sampling_denoiser(image_only_indicator), c, uc)

    def forward(self, x, sigma, image_only_indicator, *conds):
        return self.evaluate(image_only_indicator, conds)(x, sigma, self.guided)


class _Step(_Evaluation):
    """One Euler step: forward(x, sigma, next_sigma, image_only_indicator,
    *c[, *uc]) -> x at next_sigma."""

    def forward(self, x, sigma, next_sigma, image_only_indicator, *conds):
        return self.engine.sampler.step(self.evaluate(image_only_indicator, conds), x, sigma,
                                        next_sigma, self.guided)


class _Decode(nn.Module):
    def __init__(self, engine, decoding_t: Optional[int]):
        super().__init__()
        self.first_stage_model = engine.first_stage_model
        self.__dict__["engine"] = engine
        self.decoding_t = decoding_t

    def forward(self, z):
        frames = self.engine.decode_first_stage(z, self.decoding_t)
        return _unit_interval(frames).permute(0, 2, 3, 1)


class _Program(nn.Module):
    """forward(params, *inputs) = body(*inputs) with `body`'s parameters
    (`names`, in order) taken from the list `params`. `body` is held
    unregistered, so torch.export lifts none of its weights."""

    def __init__(self, body: nn.Module):
        super().__init__()
        self.__dict__["body"] = body
        self.names = [k for k, _ in (*body.named_parameters(), *body.named_buffers())]

    def forward(self, params, *inputs):
        return torch.func.functional_call(self.body, dict(zip(self.names, params)), inputs)


def _spec(t: torch.Tensor) -> Dict:
    return {"shape": list(t.shape), "stride": list(t.stride()), "dtype": str(t.dtype)[6:]}


def _export(body: nn.Module, params: Dict[str, torch.Tensor], inputs: Sequence[torch.Tensor]
            ) -> Tuple[bytes, Dict]:
    """One program: its torch.export bytes and its header entry (the
    parameters it reads, the specs of its parameters and inputs)."""
    program = _Program(body)
    missing = [k for k in program.names if k not in params]
    if missing:
        raise KeyError(f"export_sampler: params lack {len(missing)} keys, e.g. {missing[:3]}")
    weights = [params[k] for k in program.names]
    ep = torch.export.export(program, (weights, *inputs), strict=False)
    if ep.state_dict:
        raise RuntimeError(f"export_sampler: weights lifted into the program: "
                           f"{sorted(ep.state_dict)[:3]}")
    nodes = {n.name: n for n in ep.graph.nodes if n.op == "placeholder"}
    user_inputs = ep.graph_signature.user_inputs
    used = [name for name, node in zip(program.names, user_inputs) if nodes[node].users]
    # torch.export.save would store the example inputs, the weights among
    # them, and each node's source stack trace.
    ep.example_inputs = None
    for node in ep.graph.nodes:
        node.meta.pop("stack_trace", None)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue(), {"params": program.names, "used": used,
                            "param_specs": {k: _spec(params[k]) for k in used},
                            "inputs": [_spec(t) for t in inputs]}


def exports_steps(sampler) -> bool:
    """Whether an artifact of `sampler` holds whole Euler steps (an
    EulerEDMSampler without churn), not its evaluations."""
    return type(sampler) is EulerEDMSampler and not sampler.needs_step_noise


@torch.no_grad()
def export_sampler(engine, params: Dict[str, torch.Tensor], batch: Dict,
                   num_steps: Optional[int] = None, decoding_t: Optional[int] = None) -> bytes:
    """Serialise sampling for the batch's (B, T, H, W): the conditioner, the
    engine's sampler (Euler's step and plain step, or any other sampler's
    evaluation and plain evaluation, the plain ones only where a
    guidance_interval leaves some unguided) and the decode, as torch.export
    programs, with the sigma ladder. `params` is the engine's state dict
    (the programs' weights, not stored); the batch's non-array entries are
    baked in. Returns the artifact's bytes."""
    sampler = engine.sampler
    arrays, static = _split_batch(batch)
    keys = sorted(arrays)
    c, uc = engine.get_unconditional_conditioning(batch, UC_ZERO_KEYS)
    cond_keys = sorted(c)
    cs = [_channels_first(c[k]) for k in cond_keys]
    ucs = [_channels_first(uc[k]) for k in cond_keys]
    sigmas = sampler.sigmas(num_steps)
    steps = exports_steps(sampler)
    guided = sampler.guided_steps(num_steps) if steps else sampler.guided_evaluations(num_steps)
    flat = guided if steps else [g for step in guided for g in step]
    scale = float(np.sqrt(1.0 + sigmas[0] ** 2))
    frames = arrays["cond_frames"]
    ladder = torch.from_numpy(sigmas).to(frames.device)

    programs, header = {}, {"format": FORMAT, "torch": torch.__version__,
                            "device": str(frames.device), "keys": keys,
                            "cond_keys": cond_keys, "jpg": "jpg" in arrays,
                            "sigmas": [float(s) for s in sigmas], "guided": guided,
                            "init_scale": scale, "programs": {}}
    if not steps:
        header["sampler"] = sampler_record(sampler, num_steps)
    cond_in = [arrays[k] for k in keys]
    programs["cond"], header["programs"]["cond"] = _export(
        _Conditioner(engine, keys, static, cond_keys), params, cond_in)
    x = initial_latents(engine.latent_noise(frames), scale)
    ioi = arrays["image_only_indicator"]
    if steps:
        body, names = _Step, ("step", "plain")
        body_in = [x, ladder[0], ladder[1], ioi]
    else:
        body, names = _Evaluation, ("eval", "eval_plain")
        body_in = [x, ladder[0] * torch.ones(x.shape[0], device=x.device), ioi]
    if any(flat):
        programs[names[0]], header["programs"][names[0]] = _export(
            body(engine, True, cond_keys), params, body_in + cs + ucs)
    if not all(flat):
        programs[names[1]], header["programs"][names[1]] = _export(
            body(engine, False, cond_keys), params, body_in + cs)
    # The decode's example latents come out of a step or an evaluation, as
    # the latents it decodes come out of the sampler.
    z = body(engine, flat[0], cond_keys)(*body_in, *cs, *(ucs if flat[0] else []))
    programs["decode"], header["programs"]["decode"] = _export(
        _Decode(engine, decoding_t), params, [z])

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("header.json", json.dumps(header))
        for name, data in programs.items():
            zf.writestr(f"{name}.pt2", data)
    return buf.getvalue()


def _flat_graph(ep, used: List[bool]) -> torch.fx.GraphModule:
    """The program as a GraphModule called with its flat inputs, positional,
    less the parameter inputs it never reads; the pytree in/out handling
    and the per-input checks of ExportedProgram.module() are dropped (the
    loader checks its inputs itself), and so are the graph's own checks of
    what it traced (`_assert_tensor_metadata`) and its casts to the dtype a
    tensor has: each is one more host-side op call an evaluation, and the
    evaluation is host-bound."""
    gm = ep.module()
    for node in list(gm.graph.nodes):
        if ((node.op == "call_module" and node.target == "_guards_fn")
                or node.target is torch.ops.aten._assert_tensor_metadata.default):
            gm.graph.erase_node(node)
        elif (node.target is torch.ops.aten.to.dtype and len(node.args) == 2
              and not node.kwargs and "val" in node.args[0].meta
              and node.args[0].meta["val"].dtype == node.args[1]):
            node.replace_all_uses_with(node.args[0])
            gm.graph.erase_node(node)
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for node, keep in zip(placeholders, used):
        if not keep:
            gm.graph.erase_node(node)
    gm.graph._codegen = torch.fx.graph.CodeGen()
    gm.recompile()
    return gm


def _check(what: str, t: torch.Tensor, spec: Dict, device: torch.device) -> torch.Tensor:
    """t in the layout the program was exported with; raise unless its
    shape, dtype and device are the program's."""
    if (list(t.shape) != spec["shape"] or str(t.dtype)[6:] != spec["dtype"]
            or t.device != device):
        raise ValueError(f"exported sampler: {what} is {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}; the artifact takes {tuple(spec['shape'])} "
                         f"{spec['dtype']} on {device}")
    if list(t.stride()) != spec["stride"]:
        t = torch.empty_strided(spec["shape"], spec["stride"], dtype=t.dtype,
                                device=t.device).copy_(t)
    return t


class _Loaded:
    """One program of the artifact, called with (params, inputs)."""

    def __init__(self, ep, entry: Dict, device: torch.device):
        inputs = len(entry["inputs"])
        used = set(entry["used"])
        self.gm = _flat_graph(ep, [k in used for k in entry["params"]] + [True] * inputs)
        self.used, self.specs = entry["used"], entry["param_specs"]
        self.inputs, self.device = entry["inputs"], device

    def weights(self, params: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        missing = [k for k in self.used if k not in params]
        if missing:
            raise KeyError(f"exported sampler: params lack {len(missing)} keys, "
                           f"e.g. {missing[:3]}")
        return [_check(k, params[k], self.specs[k], self.device) for k in self.used]

    def __call__(self, weights: List[torch.Tensor], *inputs, names: Sequence[str] = ()):
        args = [_check(name, t, spec, self.device) for name, t, spec in
                zip(names or [f"input {i}" for i in range(len(inputs))], inputs, self.inputs)]
        out = self.gm.forward(*weights, *args)
        return out[0] if len(out) == 1 else out


def baked_batch(blob: bytes) -> Tuple[int, int, int, int]:
    """(B, T, H, W), the clips, frames and frame size an artifact was
    exported for, read from its header alone."""
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        header = json.loads(zf.read("header.json"))
    if header.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} artifact: {header.get('format')!r}")
    keys, inputs = header["keys"], header["programs"]["cond"]["inputs"]
    b, t = inputs[keys.index("image_only_indicator")]["shape"]
    _, h, w, _ = inputs[keys.index("cond_frames")]["shape"]
    return b, t, h, w


def step_noise_steps(header: Dict) -> int:
    """The steps an artifact's sampler draws per-step noise for: 0 unless
    it draws any."""
    return len(header["sigmas"]) - 1 if header.get("sampler", {}).get("step_noise") else 0


def load_sampler(blob: bytes) -> Callable:
    """Deserialise an export_sampler artifact into
    sample(params, arrays, generator=None, noise=None, step_noise=None) ->
    dict, the outputs of engine.sample_video: `params` the state dict,
    `arrays` the batch's arrays (the non-array entries were baked in), the
    latent noise `noise` (B*T, H/8, W/8, 4), and for a sampler that draws
    noise at every step its `step_noise` (steps, B*T, 4, H/8, W/8); each is
    drawn from `generator` where it is not given, the latent noise first,
    as engine.sample_video draws them. Needs the port's op library
    (gcd_tpu_torch.ops), which this module imports, and no model or
    config."""
    import gcd_tpu_torch.ops  # noqa: F401  (registers the gcd:: ops)

    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        header = json.loads(zf.read("header.json"))
        if header.get("format") != FORMAT:
            raise ValueError(f"not a {FORMAT} artifact: {header.get('format')!r}")
        if header["torch"] != torch.__version__:
            raise ValueError(f"artifact written by torch {header['torch']}; this is "
                             f"{torch.__version__}: export again with this version")
        device = torch.device(header["device"])
        programs = {name: _Loaded(torch.export.load(io.BytesIO(zf.read(f"{name}.pt2"))),
                                  entry, device)
                    for name, entry in header["programs"].items()}
    keys, n = header["keys"], len(header["cond_keys"])
    ladder = torch.tensor(header["sigmas"], dtype=torch.float32, device=device)
    guided, scale = header["guided"], header["init_scale"]
    bt, hh, ww, _ = header["programs"]["cond"]["inputs"][keys.index("cond_frames")]["shape"]
    record = header.get("sampler")
    steps = step_noise_steps(header)

    @torch.no_grad()
    def sample(params: Dict[str, torch.Tensor], arrays: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               step_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        missing = [k for k in keys if k not in arrays]
        if missing:
            raise KeyError(f"exported sampler: the arrays lack {missing}")
        weights = {name: p.weights(params) for name, p in programs.items()}
        out = programs["cond"](weights["cond"], *[arrays[k] for k in keys], names=keys)
        cs, ucs = list(out[:n]), list(out[n:2 * n])
        if noise is None:
            noise = torch.randn((bt, hh // 8, ww // 8, 4), generator=generator, device=device)
        ioi = arrays["image_only_indicator"]
        if record is None:
            x = initial_latents(noise, scale)
            for i, g in enumerate(guided):
                step = programs["step" if g else "plain"]
                x = step(weights["step" if g else "plain"], x, ladder[i], ladder[i + 1], ioi,
                         *cs, *(ucs if g else []))
        else:
            sampler, sigmas, plan = sampler_from_record(record)
            if steps and step_noise is None:
                step_noise = torch.randn((steps, bt, 4, hh // 8, ww // 8), generator=generator,
                                         device=device)

            def evaluate(xx, sigma, g):
                name = "eval" if g else "eval_plain"
                return programs[name](weights[name], xx, sigma, ioi, *cs, *(ucs if g else []))

            x = sampler.run(evaluate, _channels_first(noise).float(), sigmas, plan, step_noise)
        result = {"cond_video": out[2 * n],
                  "sampled_video": programs["decode"](weights["decode"], x)}
        if header["jpg"]:
            result["gt_video"] = out[2 * n + 1]
        return result

    sample.header, sample.programs = header, programs
    return sample
