"""Checkpoints: read a released reference `.ckpt` / `.pt` / `.safetensors`
into the port's key space, with the EMA overlay; save and restore the
trainer's own.

Port of gcd_tpu/io/convert.py `load_torch_state_dict` (:153-171) and
`extract_ema_state_dict` (:244-266), and of the steps of gcd_tpu's
`DiffusionEngine.load_torch_checkpoint` (engine.py:197-230) that come before
the key conversion, which the port does not need: its modules carry the
reference's parameter names. The result feeds
`engine_from_config(..., state_dict=sd, strict=False)` (engine/build.py,
called by engine/bundle.py), which reports the missing and unexpected keys
as the JAX engine does.

`.safetensors` is read by the few lines below that implement the documented
format (an 8-byte little-endian header length, a JSON header of
{name: {dtype, shape, data_offsets}}, then the raw little-endian tensors),
so the `safetensors` package is not needed.

Training checkpoints (port of gcd_tpu/io/checkpoint.py:17-68, the same
layout and resume rules): `{ckpt_dir}/step_N/checkpoint.pt`, one torch save
of {"module": the engine's state dict, "masters": the fp32 masters by
parameter name, "optimizer": the optimizer's state dict, "global_step"}
(engine/trainer.py `Trainer.state_dict`). A save goes to a temporary
directory that is renamed into place, so an interrupted save never looks
like a checkpoint; a restore maps the file (mmap) rather than reading a
second copy into host memory.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import struct
from typing import Any, Dict, Optional

import torch

# LitEma's (sgm/modules/ema.py) shadow prefix, and its two bookkeeping buffers.
EMA_PREFIX = "model_ema."
EMA_BOOKKEEPING = ("num_updates", "decay")
UNET_PREFIX = "model.diffusion_model."
STEP_RE = re.compile(r"^step_(\d+)$")
CHECKPOINT_FILE = "checkpoint.pt"

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a .safetensors file, on the CPU."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        if end == begin:
            out[name] = torch.empty(info["shape"], dtype=dtype)
        else:
            out[name] = torch.frombuffer(data, dtype=dtype, count=(end - begin) // dtype.itemsize,
                                         offset=begin).reshape(info["shape"])
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors`, or a torch `.ckpt` / `.pt` (its "state_dict" entry
    when it has one), as {key: CPU tensor}; entries that are not tensors
    are dropped."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def extract_ema_state_dict(sd: Dict) -> Dict:
    """The EMA weights LitEma stores under `model_ema.` with the dots of the
    original parameter names stripped, re-keyed as `model.diffusion_model.*`
    through the live UNet keys of the same dict; empty if there are none."""
    ema_keys = [k for k in sd if k.startswith(EMA_PREFIX)]
    if not ema_keys:
        return {}
    flat_to_orig = {k[len("model."):].replace(".", ""): k
                    for k in sd if k.startswith(UNET_PREFIX)}
    out = {}
    for k in ema_keys:
        flat = k[len(EMA_PREFIX):]
        if flat in EMA_BOOKKEEPING:
            continue
        orig = flat_to_orig.get(flat)
        if orig is not None:
            out[orig] = sd[k]
    return out


def checkpoint_state_dict(path: str, use_ema: bool = False, ablate_unet_scratch: bool = False,
                          verbose: bool = False) -> Dict[str, torch.Tensor]:
    """A released checkpoint as a state dict for load_engine: with
    `ablate_unet_scratch` every key holding "diffusion" is dropped (the UNet
    then keeps its fresh weights); with `use_ema` the EMA shadows replace
    the live UNet weights (the reference's ema_scope at evaluation)."""
    sd = load_torch_state_dict(path)
    if ablate_unet_scratch:
        sd = {k: v for k, v in sd.items() if "diffusion" not in k.lower()}
    if use_ema:
        ema = extract_ema_state_dict(sd)
        if ema:
            if verbose:
                print(f"Using {len(ema)} EMA shadow tensors for the UNet")
            sd = dict(sd)
            sd.update(ema)
    return sd


def save_checkpoint(ckpt_dir: str, step: int, state: Dict[str, Any]) -> str:
    """Write `state` as `{ckpt_dir}/step_{step}`, replacing one of that step;
    returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    tmp = os.path.join(os.path.abspath(ckpt_dir), f".step_{step}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state, os.path.join(tmp, CHECKPOINT_FILE))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest N of the `step_N` directories under `ckpt_dir`, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(STEP_RE.match, os.listdir(ckpt_dir))
             if m and os.path.isdir(os.path.join(ckpt_dir, m.group(0)))]
    return max(steps) if steps else None


def is_training_checkpoint(path: str) -> bool:
    """Whether `path` is a `step_N` directory this module wrote."""
    return os.path.isfile(os.path.join(path, CHECKPOINT_FILE))


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The state saved as `{ckpt_dir}/step_{step}` (the latest step when
    None), its tensors on the CPU, mapped from the file."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    if not is_training_checkpoint(path):
        raise FileNotFoundError(f"{path} holds no {CHECKPOINT_FILE}: not a checkpoint of "
                                "gcd_tpu_torch's trainer")
    return torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu", mmap=True,
                      weights_only=True)


def find_resume_logdir(resume: str) -> str:
    """`--resume` takes a run directory or a path inside its checkpoints."""
    resume = os.path.abspath(resume)
    if os.path.isdir(os.path.join(resume, "checkpoints")):
        return resume
    parts = resume.rstrip("/").split("/")
    if "checkpoints" in parts:
        return "/".join(parts[: parts.index("checkpoints")])
    return resume
