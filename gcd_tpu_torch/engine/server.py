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

Noise: each clip's latent noise comes from a torch.Generator on the card
seeded with its request's seed, so a request's frames do not depend on its
batch-mates (the JAX server folds the request keys into one key instead).

Kernel switches are per thread and the worker thread starts with none set:
`make_engine_sample_fn` captures the caller's `current_flags()` when it is
made and re-enters them around every call.

HTTP front end: gcd_tpu_torch/serve.py.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

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


class SamplerServer:
    """Batch scheduler around a fixed-shape sampling function."""

    def __init__(self, sample_fn: Callable[[Dict, Sequence[int]], Dict], num_frames: int,
                 max_batch: int = 2, max_wait_ms: float = 20.0):
        """sample_fn(batch, seeds) -> dict of (max_batch*T)-leading outputs,
        for a (max_batch*T)-leading batch and one seed per clip
        (make_engine_sample_fn)."""
        self._sample_fn = sample_fn
        self._t = int(num_frames)
        self._max_batch = int(max_batch)
        self._max_wait_s = float(max_wait_ms) / 1e3
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._started = False
        self.batches_run = 0
        self.requests_served = 0

    def start(self) -> "SamplerServer":
        if not self._started:
            self._started = True
            self._worker.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the worker after its current batch; fail every request still
        queued, and refuse new ones."""
        self._stop.set()
        self._queue.put(None)  # wake the worker
        if self._started:
            self._worker.join(timeout=timeout)
        self._fail_pending(RuntimeError("server stopped"))

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
        """Block for the first request, then take up to max_batch - 1 more,
        waiting at most max_wait_ms for each."""
        first = self._queue.get()
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
        while not self._stop.is_set():
            group = self._collect()
            if not group:
                continue
            clips, seeds, futs = zip(*group)
            try:
                batch = _concat_requests(list(clips), self._max_batch)
                seeds = list(seeds) + [seeds[-1]] * (self._max_batch - len(seeds))
                out = self._sample_fn(batch, seeds)
                bt = self._max_batch * self._t
                for i, fut in enumerate(futs):
                    fut.set_result({k: _to_host(v[i * self._t:(i + 1) * self._t])
                                    for k, v in out.items()
                                    if getattr(v, "ndim", 0) >= 1 and v.shape[0] == bt})
                self.batches_run += 1
                self.requests_served += len(futs)
            except Exception as e:  # deliver it, keep the loop alive
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)


def make_engine_sample_fn(engine, max_batch: int, num_frames: int,
                          num_steps: Optional[int] = None, decoding_t: Optional[int] = None
                          ) -> Callable[[Dict, Sequence[int]], Dict]:
    """sample_fn(batch, seeds) for SamplerServer: the engine's sample_video
    on the engine's device, with the kernel switches in force where this is
    called, and each clip's latent noise from its own seeded generator. The
    decoder's chunk (`decoding_t`, else the engine's
    en_and_decode_n_samples_a_time, else a clip) must divide `num_frames`:
    the video decoder mixes the frames of a chunk, and a chunk across two
    clips would make a request's frames depend on its batch-mate."""
    flags = current_flags()
    device = next(engine.parameters()).device
    chunk = decoding_t or getattr(engine, "en_and_decode_n_samples_a_time", None) or num_frames
    if num_frames % chunk:
        raise ValueError(f"decoding chunk {chunk} does not divide num_frames={num_frames}; "
                         "pass a decoding_t that does")

    def sample_fn(batch: Dict, seeds: Sequence[int]) -> Dict:
        if len(seeds) != max_batch:
            raise ValueError(f"expected {max_batch} seeds, got {len(seeds)}")
        arrays = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                  for k, v in batch.items() if k != "num_video_frames" and not np.isscalar(v)}
        _, h, w, _ = arrays["cond_frames"].shape
        shape = (num_frames, h // LATENT_DOWNSAMPLE, w // LATENT_DOWNSAMPLE, LATENT_CHANNELS)
        noise = torch.cat([torch.randn(shape, device=device,
                                       generator=torch.Generator(device).manual_seed(int(s)))
                           for s in seeds])
        with torch.no_grad(), kernel_flags(**flags):
            return engine.sample_video(arrays, noise=noise, num_steps=num_steps,
                                       decoding_t=decoding_t)

    return sample_fn
