"""Request batching for the sampling path (port of gcd_tpu/engine/server.py).

Clients send one clip at a time; the engine is fastest, and keeps one set of
shapes, when it samples a fixed number of clips together. `SamplerServer`
bridges the two:

  * requests (one clip each: batch-dict arrays with a (T, ...) leading axis,
    and an integer seed) enter a queue;
  * one worker thread packs up to `max_batch` of them -- waiting at most
    `max_wait_ms` for stragglers -- into one (max_batch*T)-leading batch,
    padding the tail with copies of the last clip so the UNet always sees
    the same shape;
  * the results are split back per request, moved to the host, and
    delivered through futures; the padded tail is dropped.

Noise: each clip's latent noise, and then the per-step noise of a sampler
that draws it, come from a torch.Generator on the card seeded with its
request's seed, so a request's frames do not depend on its batch-mates
(the JAX server folds the request keys into one key instead).

Kernel switches are per thread and the worker thread starts with none set:
`make_engine_sample_fn` captures the caller's `current_flags()` when it is
made and re-enters them around every call.

Across processes (one a card, parallel/distributed.py; the sharded sampler
of engine/serving.py, which every process of the mesh calls with the same
batch): process 0 keeps the queue, the batching and the padding, and its
worker thread, for each batch, (1) checks it (`batch_check`), so that a bad
request is answered with an error before any collective; (2) sends it to
the group (`send_batch`: a small JSON header of the keys, shapes, dtypes,
scalars and seeds, then each array as a tensor); (3) calls the sharded
`sample_fn`; (4) learns whether every process got through the batch
(`all_ok`). The other processes run `follow(sample_fn, device)`, which
receives each batch, makes the same call, drops the outputs and joins (4).
`stop()` ends process 0's worker, which sends the stop header, so every
follower returns. Every collective on process 0 comes from the worker
thread. A batch that fails on a process fails its requests and is logged
there, and the server goes on, since every process reached (4) in step; a
collective that fails or times out (a process out of step) ends the
worker, and `serve.py` then exits non-zero on every process.

HTTP front end: gcd_tpu_torch/serve.py.
"""

from __future__ import annotations

import json
import queue
import threading
import traceback
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gcd_tpu_torch.ops.dispatch import current_flags, kernel_flags

LATENT_CHANNELS = 4
LATENT_DOWNSAMPLE = 8


def _concat_requests(clips: List[Dict], pad_to: int) -> Dict:
    """Stack per-clip batches into one (B*T)-leading batch, padding with
    copies of the last clip up to `pad_to` clips; scalars are kept."""
    padded = list(clips) + [clips[-1]] * (pad_to - len(clips))
    out: Dict = {}
    for k, v0 in padded[0].items():
        if k == "num_video_frames" or np.isscalar(v0):
            out[k] = v0
        else:
            out[k] = np.concatenate([np.asarray(c[k]) for c in padded], axis=0)
    return out


def _to_host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def batch_check(keys: Sequence[str], max_batch: int, num_frames: int,
                frame_hw: Optional[Tuple[int, int]] = None) -> Callable[[Dict], None]:
    """check(batch) for SamplerServer: raises ValueError unless the packed
    batch has every array of `keys`, each array numeric with
    max_batch * num_frames rows (the indicator (max_batch, num_frames)),
    and "cond_frames" (max_batch * num_frames, H, W, 3) with H and W
    multiples of 8 (the served `frame_hw` when given)."""
    bt = max_batch * num_frames

    def check(batch: Dict) -> None:
        missing = [k for k in keys if k not in batch or np.isscalar(batch[k])]
        if missing:
            raise ValueError(f"the request lacks the arrays {missing}")
        for k, v in batch.items():
            if k == "num_video_frames" or np.isscalar(v):
                continue
            v = np.asarray(v)
            if not (np.issubdtype(v.dtype, np.number) or v.dtype == bool):
                raise ValueError(f"{k}: {v.dtype} is not numeric")
            want = (max_batch, num_frames) if k == "image_only_indicator" else (bt,)
            if v.shape[:len(want)] != want:
                raise ValueError(f"{k}: {v.shape} in the batch, expected {want} leading")
        frames = np.asarray(batch["cond_frames"]).shape
        hw = tuple(frames[1:3])
        if (len(frames) != 4 or frames[3] != 3 or hw[0] % LATENT_DOWNSAMPLE
                or hw[1] % LATENT_DOWNSAMPLE or (frame_hw is not None
                                                 and hw != tuple(frame_hw))):
            raise ValueError(f"cond_frames {frames[1:]} a frame; the server takes "
                             f"{tuple(frame_hw) if frame_hw else '(H, W)'} x 3, "
                             f"H and W multiples of {LATENT_DOWNSAMPLE}")

    return check


# The protocol of a served mesh: process 0 broadcasts each batch over the
# default process group, on `device` (the card under NCCL, the CPU under
# gloo). An idle process 0 sends an idle header every IDLE_S seconds, so
# that no follower waits in a collective longer than that (a collective
# fails after parallel/distributed.py's TIMEOUT).
IDLE_S = 60.0


def _broadcast_json(obj, device: torch.device) -> Dict:
    """`obj` (process 0's; None elsewhere) on every process: its length,
    then its UTF-8 bytes."""
    raw = json.dumps(obj).encode() if obj is not None else b""
    n = torch.tensor([len(raw)], dtype=torch.int64, device=device)
    dist.broadcast(n, src=0)
    buf = (torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device) if raw
           else torch.empty(int(n.item()), dtype=torch.uint8, device=device))
    dist.broadcast(buf, src=0)
    return json.loads(bytes(buf.cpu().numpy()).decode())


def send_batch(batch: Dict, seeds: Sequence[int], device: torch.device) -> Dict:
    """Process 0: the header of `batch` and `seeds`, then each array as a
    tensor, to the group. Returns the batch with its arrays as the tensors
    sent (on `device`)."""
    arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
              for k, v in batch.items() if k != "num_video_frames" and not np.isscalar(v)}
    scalars = {k: v.item() if hasattr(v, "item") else v for k, v in batch.items()
               if k not in arrays}
    _broadcast_json({"kind": "batch", "seeds": [int(s) for s in seeds], "scalars": scalars,
                     "arrays": [[k, list(t.shape), str(t.dtype)[6:]] for k, t in arrays.items()]},
                    device)
    for t in arrays.values():
        dist.broadcast(t, src=0)
    return {**scalars, **arrays}


def send_header(kind: str, device: torch.device) -> None:
    """Process 0: the "idle" header, or the "stop" one (every follower
    returns)."""
    _broadcast_json({"kind": kind}, device)


def receive_batch(device: torch.device) -> Optional[Tuple[Dict, List[int]]]:
    """A follower: process 0's next (batch, seeds), or None at the stop."""
    header = _broadcast_json(None, device)
    while header["kind"] == "idle":
        header = _broadcast_json(None, device)
    if header["kind"] == "stop":
        return None
    batch = dict(header["scalars"])
    for k, shape, dtype in header["arrays"]:
        batch[k] = torch.empty(shape, dtype=getattr(torch, dtype), device=device)
        dist.broadcast(batch[k], src=0)
    return batch, header["seeds"]


def all_ok(ok: bool, device: torch.device) -> int:
    """How many processes of the group did not get through the batch
    (0: all did); every process calls it after each batch."""
    failed = torch.tensor([0 if ok else 1], dtype=torch.int64, device=device)
    dist.all_reduce(failed)
    return int(failed.item())


def follow(sample_fn: Callable[[Dict, Sequence[int]], Dict], device: torch.device) -> int:
    """A follower process of a served mesh: sample_fn on each batch process
    0 sends, the outputs dropped, until the stop header. A batch that fails
    here is logged and reported to process 0 (all_ok). Returns the number of
    batches followed."""
    n = 0
    while True:
        got = receive_batch(device)
        if got is None:
            return n
        ok = True
        try:
            sample_fn(*got)
        except Exception:  # report it to process 0, stay in step
            traceback.print_exc()
            ok = False
        all_ok(ok, device)
        n += 1


class SamplerServer:
    """Batch scheduler around a fixed-shape sampling function."""

    def __init__(self, sample_fn: Callable[[Dict, Sequence[int]], Dict], num_frames: int,
                 max_batch: int = 2, max_wait_ms: float = 20.0,
                 check: Optional[Callable[[Dict], None]] = None,
                 mesh_device: Optional[torch.device] = None):
        """sample_fn(batch, seeds) -> dict of (max_batch*T)-leading outputs,
        for a (max_batch*T)-leading batch and one seed per clip
        (make_engine_sample_fn). `check(batch)` (batch_check) raises on a
        batch sample_fn cannot take; it runs before anything else. With
        `mesh_device`, this is process 0 of a served mesh: each batch is
        sent to the group's other processes, which run `follow`, on that
        device."""
        self._sample_fn = sample_fn
        self._check = check
        self._device = mesh_device
        self._t = int(num_frames)
        self._max_batch = int(max_batch)
        self._max_wait_s = float(max_wait_ms) / 1e3
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._done = threading.Event()  # set when the worker ends
        self._started = False
        self.batches_run = 0
        self.requests_served = 0
        # The exception that ended the worker (a collective that failed).
        self.error: Optional[BaseException] = None

    def start(self) -> "SamplerServer":
        if not self._started:
            self._started = True
            self._worker.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the worker after its current batch (on a mesh it then sends
        the stop header); fail every request still queued, and refuse new
        ones."""
        self._stop.set()
        self._queue.put(None)  # wake the worker
        if self._started:
            self._worker.join(timeout=timeout)
        self._fail_pending(RuntimeError("server stopped"))

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the worker has ended (after stop(), or when a
        collective failed: `error`); returns whether it has. (An event, not
        a join: a join that Ctrl-C interrupts can mark a running thread
        stopped.)"""
        return self._done.wait(timeout)

    def submit(self, clip_batch: Dict, seed: Optional[int] = None) -> Future:
        """Enqueue one clip (arrays with a (T, ...) leading axis). Returns a
        Future of its sample_video outputs as host arrays. Without a seed
        the clip's noise seed is drawn at random."""
        if self._stop.is_set():
            raise RuntimeError("server stopped")
        t = int(np.asarray(clip_batch["image_only_indicator"]).shape[-1])
        if t != self._t:
            raise ValueError(f"server built for T={self._t}, got T={t}")
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        fut: Future = Future()
        self._queue.put((clip_batch, int(seed), fut))
        return fut

    def _fail_pending(self, exc: Exception) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None and not item[2].done():
                item[2].set_exception(exc)

    def _collect(self) -> List:
        """Block for the first request (at most IDLE_S on a mesh), then take
        up to max_batch - 1 more, waiting at most max_wait_ms for each."""
        try:
            first = self._queue.get(timeout=IDLE_S if self._device is not None else None)
        except queue.Empty:
            return []
        if first is None:
            return []
        group = [first]
        while len(group) < self._max_batch:
            try:
                nxt = self._queue.get(timeout=self._max_wait_s)
            except queue.Empty:
                break
            if nxt is None:
                break
            group.append(nxt)
        return group

    def _run(self) -> None:
        if self._device is not None and self._device.index is not None:
            torch.cuda.set_device(self._device)  # the card is per thread
        try:
            while not self._stop.is_set():
                group = self._collect()
                try:
                    if group:
                        self._serve(group)
                    elif self._device is not None and not self._stop.is_set():
                        send_header("idle", self._device)
                except BaseException as e:
                    for _, _, fut in group:
                        if not fut.done():
                            fut.set_exception(e)
                    raise
            if self._device is not None:
                send_header("stop", self._device)
        except Exception as e:  # a collective failed: the group is out of step
            traceback.print_exc()
            self.error = e
            self._stop.set()
            self._fail_pending(RuntimeError(f"server failed: {e}"))
        finally:
            self._done.set()

    def _serve(self, group: List) -> None:
        clips, seeds, futs = zip(*group)
        out, err = None, None
        try:
            batch = _concat_requests(list(clips), self._max_batch)
            seeds = list(seeds) + [seeds[-1]] * (self._max_batch - len(seeds))
            if self._check is not None:
                self._check(batch)
        except Exception as e:  # a bad request: answered before any collective
            err = e
        else:
            if self._device is not None:
                batch = send_batch(batch, seeds, self._device)
                try:
                    out = self._sample_fn(batch, seeds)
                except Exception as e:
                    traceback.print_exc()
                    err = e
                failed = all_ok(err is None, self._device)
                if err is None and failed:
                    err = RuntimeError(f"the batch failed on {failed} process(es) of the mesh")
            else:
                try:
                    out = self._sample_fn(batch, seeds)
                except Exception as e:
                    err = e
        if err is not None:  # deliver it, keep the loop alive
            for fut in futs:
                if not fut.done():
                    fut.set_exception(err)
            return
        bt = self._max_batch * self._t
        for i, fut in enumerate(futs):
            fut.set_result({k: _to_host(v[i * self._t:(i + 1) * self._t])
                            for k, v in out.items()
                            if getattr(v, "ndim", 0) >= 1 and v.shape[0] == bt})
        self.batches_run += 1
        self.requests_served += len(futs)


def sample_keys(engine) -> List[str]:
    """The batch arrays engine.sample_video reads: its conditioner's inputs,
    the frames and the indicator."""
    keys = list(getattr(getattr(engine, "conditioner", None), "input_keys", []))
    return sorted(set(keys) | {"cond_frames", "image_only_indicator"})


def seeded_noise(seeds: Sequence[int], num_frames: int, frame_hw: Tuple[int, int],
                 device: torch.device, steps: int = 0
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Each clip's noise from a torch.Generator on `device` seeded with its
    seed: its latent noise (T, H/8, W/8, 4), then, for a sampler that draws
    noise at each of its `steps` steps, its per-step noise (steps, T, 4,
    H/8, W/8). Returns the clips' latent noise stacked (len(seeds)*T, ...)
    and their per-step noise stacked on the row axis (steps, len(seeds)*T,
    ...), None when `steps` is 0."""
    h, w = frame_hw[0] // LATENT_DOWNSAMPLE, frame_hw[1] // LATENT_DOWNSAMPLE
    noise, step_noise = [], []
    for s in seeds:
        gen = torch.Generator(device).manual_seed(int(s))
        noise.append(torch.randn((num_frames, h, w, LATENT_CHANNELS), device=device,
                                 generator=gen))
        if steps:
            step_noise.append(torch.randn((steps, num_frames, LATENT_CHANNELS, h, w),
                                          device=device, generator=gen))
    return torch.cat(noise), torch.cat(step_noise, dim=1) if steps else None


def _seeded_sample_fn(run: Callable, max_batch: int, num_frames: int,
                      device: torch.device, steps: int = 0
                      ) -> Callable[[Dict, Sequence[int]], Dict]:
    """sample_fn(batch, seeds) -> run(arrays, noise, step_noise): the
    batch's arrays as fp32 tensors on `device` and each clip's
    seeded_noise (with its noise for `steps` steps), under the kernel
    switches in force where this is called."""
    flags = current_flags()

    def sample_fn(batch: Dict, seeds: Sequence[int]) -> Dict:
        if len(seeds) != max_batch:
            raise ValueError(f"expected {max_batch} seeds, got {len(seeds)}")
        arrays = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                  for k, v in batch.items() if k != "num_video_frames" and not np.isscalar(v)}
        noise, step_noise = seeded_noise(seeds, num_frames, arrays["cond_frames"].shape[1:3],
                                         device, steps)
        with torch.no_grad(), kernel_flags(**flags):
            return run(arrays, noise, step_noise)

    return sample_fn


def make_engine_sample_fn(engine, max_batch: int, num_frames: int,
                          num_steps: Optional[int] = None, decoding_t: Optional[int] = None,
                          mesh=None) -> Callable[[Dict, Sequence[int]], Dict]:
    """sample_fn(batch, seeds) for SamplerServer: the engine's sample_video
    on the engine's device, with the kernel switches in force where this is
    called, and each clip's latent noise from its own seeded generator
    (seeded_noise: the latent noise, then the sampler's per-step noise
    where it draws any). With a `mesh` (parallel/mesh.py) it samples through
    engine/serving.py's sharded sampler over it, with that noise: every
    process of the mesh must call it with the same batch and seeds
    (SamplerServer on process 0, `follow` on the others). The decoder's
    chunk (`decoding_t`, else the engine's en_and_decode_n_samples_a_time,
    else a clip) must divide `num_frames`: the video decoder mixes the
    frames of a chunk, and a chunk across two clips would make a request's
    frames depend on its batch-mate."""
    device = next(engine.parameters()).device
    chunk = decoding_t or getattr(engine, "en_and_decode_n_samples_a_time", None) or num_frames
    if num_frames % chunk:
        raise ValueError(f"decoding chunk {chunk} does not divide num_frames={num_frames}; "
                         "pass a decoding_t that does")
    if mesh is not None:
        from gcd_tpu_torch.engine.serving import make_sharded_sampler

        run = make_sharded_sampler(engine, mesh, num_steps=num_steps, decoding_t=decoding_t)
    else:
        def run(arrays, noise, step_noise):
            extra = {} if step_noise is None else {"step_noise": step_noise}
            return engine.sample_video(arrays, noise=noise, num_steps=num_steps,
                                       decoding_t=decoding_t, **extra)
    sampler = getattr(engine, "sampler", None)
    steps = len(sampler.sigmas(num_steps)) - 1 if getattr(sampler, "needs_step_noise", 0) else 0
    return _seeded_sample_fn(run, max_batch, num_frames, device, steps)


def make_artifact_sample_fn(sample: Callable, params: Dict[str, torch.Tensor], max_batch: int,
                            num_frames: int) -> Callable[[Dict, Sequence[int]], Dict]:
    """sample_fn(batch, seeds) for SamplerServer over an exported sampler
    (engine/export.py load_sampler's `sample`, with the engine's state dict
    `params`): each clip's noise as make_engine_sample_fn draws it, on the
    artifact's device: its latent noise, then the per-step noise of a
    sampler that draws any."""
    from gcd_tpu_torch.engine.export import step_noise_steps

    def run(arrays, noise, step_noise):
        return sample(params, arrays, noise=noise, step_noise=step_noise)

    return _seeded_sample_fn(run, max_batch, num_frames, torch.device(sample.header["device"]),
                             step_noise_steps(sample.header))
