"""Serving-side decoder LM: prefill/decode split over a paged KV cache.

Port of ``paddle_tpu/serving/model.py``: the SAME parameter names
(``gpt.h<i>.attn.q.w`` ...), layouts and tied-embedding lm head, run
eagerly in PyTorch on one device:

- **prefill**: the whole (bucket-padded) prompt in one causal pass,
  writing every position's K/V into the request's cache blocks and
  returning the first generated token;
- **decode**: one token per active batch slot per tick, gathering each
  request's context through its block table and scattering the new
  token's K/V into the tail slot;
- **score**: per-token NLL of a prompt through the fused lm-head + CE
  kernel (``ops/lmhead_ce.py``), so the [tokens, vocab] logits are never
  written to device memory.

The JAX package jit-compiles each of these per bucket (``_jit_for``) and
captures its XLA cost plan. The port's counterpart of that compile is
the CUDA graph (``framework/replay.py``): on the card each program --
decode at ``max_batch``, prefill and score per bucket -- is a body over
static device buffers that runs eagerly once, is then captured and
replayed. The host arrays each call takes (tokens, block tables,
positions, the prompt's length) are copied into the program's buffers
before the replay, and the host reads (the next tokens, the NLL) come
after it. Prefill and decode write the pages they were captured on, so
their programs are bound to one pages tensor: a call with another pages
tensor drops them and warms and captures anew (:meth:`warm` does both
ahead of traffic). A model's programs never run at once and each
output is read right after its replay, so they share one graph memory
pool. ``PADDLE_TPU_EAGER=1`` runs the same bodies eagerly; the CPU
always does, unless ``staged`` (tests: the same staging, the body called
directly). No XLA cost plan exists here: ``insights`` stays empty and
:meth:`decode_roofline` returns None. Multi-device recipes are not
ported: any recipe raises.

Numerical contract the engine's tests lean on: every per-row computation
in decode depends only on that row's inputs and that request's own cache
blocks (padded table entries point at the reserved scratch block 0 and
are masked with a finite -1e30 before the softmax), and decode always
runs at ``max_batch`` rows, so the same request produces BIT-IDENTICAL
tokens whether it decodes alone or batched with others.

The KV pages are updated IN PLACE (a second full pages buffer would cost
as much device memory as the cache itself); :meth:`prefill` and
:meth:`decode` return the same tensor they were given, and the engine
assigns it back as the JAX engine does.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import flags as _flags
from ..framework import errors as _errors
from ..framework.replay import Captured, replays
from ..models.gpt import GPTConfig
from ..ops.lmhead_ce import lmhead_ce
from ..weights import params_from_numpy, torch_dtype
from .kv_cache import blocks_for_tokens

__all__ = ["GPTConfig", "DecodeModel", "init_params", "calibrate"]

_NEG = -1e30  # finite mask value: garbage behind it stays non-NaN


def init_params(cfg: GPTConfig, seed: int = 0) -> Dict[str, np.ndarray]:
    """Random GPT parameters under the models/gpt.py naming scheme, drawn
    with numpy exactly as the JAX package draws them, so one seed gives
    both packages the same weights. Real deployments load a checkpoint
    with the same names (``weights.params_from_numpy``)."""
    r = np.random.RandomState(seed)
    d, v, t = cfg.d_model, cfg.vocab_size, cfg.max_seq_len
    dff = cfg.ffn_dim

    def norm(*shape, std=0.02):
        return (r.randn(*shape) * std).astype(cfg.dtype)

    p: Dict[str, np.ndarray] = {
        "gpt.wte": norm(v, d),
        "gpt.wpe": norm(t, d),
        "gpt.lnf.scale": np.ones(d, cfg.dtype),
        "gpt.lnf.bias": np.zeros(d, cfg.dtype),
    }
    res_std = 0.02 / math.sqrt(2 * cfg.n_layer)
    for i in range(cfg.n_layer):
        ln = f"gpt.h{i}"
        for part in ("q", "k", "v"):
            p[f"{ln}.attn.{part}.w"] = norm(d, d)
            p[f"{ln}.attn.{part}.b"] = np.zeros(d, cfg.dtype)
        p[f"{ln}.attn.proj.w"] = norm(d, d, std=res_std)
        p[f"{ln}.attn.proj.b"] = np.zeros(d, cfg.dtype)
        p[f"{ln}.mlp.fc_in.w"] = norm(d, dff)
        p[f"{ln}.mlp.fc_in.b"] = np.zeros(dff, cfg.dtype)
        p[f"{ln}.mlp.fc_out.w"] = norm(dff, d, std=res_std)
        p[f"{ln}.mlp.fc_out.b"] = np.zeros(d, cfg.dtype)
        for nrm in ("ln1", "ln2"):
            p[f"{ln}.{nrm}.scale"] = np.ones(d, cfg.dtype)
            p[f"{ln}.{nrm}.bias"] = np.zeros(d, cfg.dtype)
    return p


def _resolve_device(device=None) -> torch.device:
    """The device a model runs on: ``cuda`` unless the caller names one.
    With no device and no usable CUDA card this raises; it never falls
    back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise _errors.errors.Unavailable(
                "paddle_tpu_torch serves on a CUDA card and none is "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def calibrate(n: int = 384, copy_mb: int = 16,
              device=None) -> Dict[str, float]:
    """Measure this device's achievable matmul FLOPs/s, memory bandwidth
    and per-op dispatch floor -- the denominators of the decode roofline.
    Best of 3 warm runs, timed with CUDA events on a card and with the
    host clock on the CPU; deliberately coarse (a roofline is a bound,
    not a benchmark)."""
    dev = _resolve_device(device)

    def best(fn, *args):
        fn(*args)  # warm
        ts = []
        for _ in range(3):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                fn(*args)
                ts.append(time.perf_counter() - t0)
        return min(ts)

    gen = torch.Generator(device="cpu").manual_seed(0)
    a = torch.randn(n, n, generator=gen).to(dev)
    t_mm = best(torch.matmul, a, a)
    m = (copy_mb << 20) // 4
    x = torch.ones(m, device=dev)
    t_cp = best(torch.mul, x, 1.0000001)
    s = torch.ones((), device=dev)
    t_disp = best(torch.add, s, 1.0)
    return {
        "flops_per_sec": (2.0 * n ** 3) / max(t_mm, 1e-9),
        "bytes_per_sec": (2.0 * m * 4) / max(t_cp, 1e-9),
        "dispatch_s": t_disp,
    }


class DecodeModel:
    """The engine's compute plane: prefill/decode/score over a fixed
    (max_batch, kv layout) envelope on one device."""

    def __init__(self, cfg: GPTConfig,
                 params: Optional[Dict[str, Any]] = None,
                 recipe: Optional[Any] = None,
                 max_batch: Optional[int] = None,
                 n_blocks: Optional[int] = None,
                 block_size: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 seed: int = 0,
                 device=None):
        self.device = _resolve_device(device)
        # fp32 products stay full fp32 on the card: the engine's greedy
        # tokens are compared across shapes (batched vs sequential, paged
        # decode vs the full_logits reference), and TF32's ~3 decimal
        # digits would flip near-tied argmaxes between them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        self.max_batch = int(max_batch if max_batch is not None
                             else _flags.env_flag("PADDLE_TPU_SERVE_MAX_BATCH"))
        self.n_blocks = int(n_blocks if n_blocks is not None
                            else _flags.env_flag("PADDLE_TPU_SERVE_KV_BLOCKS"))
        self.block_size = int(
            block_size if block_size is not None
            else _flags.env_flag("PADDLE_TPU_SERVE_BLOCK_SIZE"))
        if prefill_buckets is None:
            raw = str(_flags.env_flag("PADDLE_TPU_SERVE_PREFILL_BUCKETS"))
            prefill_buckets = [int(x) for x in raw.split(",") if x.strip()]
        self.prefill_buckets = sorted(
            min(int(b), cfg.max_seq_len) for b in prefill_buckets)
        # every request's gather window: the whole (block-padded) context
        self.max_blocks_per_req = blocks_for_tokens(cfg.max_seq_len,
                                                    self.block_size)
        self.gather_len = self.max_blocks_per_req * self.block_size

        if recipe is None:
            recipe = str(_flags.env_flag("PADDLE_TPU_SERVE_RECIPE")).strip()
        if recipe:
            raise _errors.errors.Unimplemented(
                f"multi-device serving (recipe {recipe!r}) is not ported "
                f"to paddle_tpu_torch yet; serve on one device")
        self.recipe = None
        self.mesh = None
        self.rules: List[Tuple[str, Tuple]] = []
        self.sharding_mismatches: List[dict] = []

        host = params if params is not None else init_params(cfg, seed)
        self.params = self._place(host)
        self.insights: Dict[str, Any] = {}
        # the compiled route on the CPU, the body called directly (tests)
        self.staged = False
        self._programs: Dict[Any, "_Program"] = {}
        self._bound_pages: Optional[Tuple[torch.Tensor, int]] = None
        self._pool = None

    def _place(self, params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out = {}
        for name, arr in params.items():
            if isinstance(arr, torch.Tensor):
                t = arr.detach().to(device=self.device, dtype=self.dtype)
            else:
                t = params_from_numpy({name: arr}, self.device,
                                      self.dtype)[name]
            out[name] = t.contiguous()
        return out

    # -- device ---------------------------------------------------------

    def synchronize(self) -> None:
        """Wait for this model's device work (a no-op on the CPU)."""
        _sync(self.device)

    def bind_thread(self) -> None:
        """Make this model's card the calling thread's current CUDA
        device (a no-op on the CPU): CUDA's current device is per thread."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def init_pages(self, n_blocks: Optional[int] = None) -> torch.Tensor:
        """Zeroed KV pages [L, 2, NB, BS, H, hd] (block 0 = scratch)."""
        shape = (self.cfg.n_layer, 2,
                 self.n_blocks if n_blocks is None else int(n_blocks),
                 self.block_size, self.cfg.n_head, self.cfg.head_dim)
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def _ids(self, a, dtype=torch.int64) -> torch.Tensor:
        """A host array of indices as an int64 tensor on the device
        (int32 on the JAX side; torch indexes with int64)."""
        return torch.as_tensor(np.asarray(a, np.int64), dtype=dtype,
                               device=self.device)

    # -- programs -------------------------------------------------------

    def _run(self, key, body, pages, **host):
        """``body(pages, **inputs)``, each host array of ``host`` an
        int64 tensor on the device: eagerly, or on the compiled route
        through the program ``key`` (its static buffers filled first).
        Returns the body's outputs (on the compiled route the program's
        own, which its next replay overwrites)."""
        ins = {k: torch.as_tensor(np.asarray(a, np.int64))
               for k, a in host.items()}
        if not replays(self.device, self.staged):
            return body(pages, **{k: t.to(self.device)
                                  for k, t in ins.items()})
        prog = self._program(key, body, pages, ins)
        for k, t in ins.items():
            prog.inputs[k].copy_(t)
        return prog.run()[0]

    def _program(self, key, body, pages, ins) -> "_Program":
        bound = self._bound_pages
        if pages is not None and (bound is None or bound[0] is not pages
                                  or bound[1] != pages.data_ptr()):
            # a graph writes the pages it was captured on: the programs
            # bound to other pages go, and are never replayed on these
            self._programs = {k: p for k, p in self._programs.items()
                              if p.pages is None}
            self._bound_pages = (pages, pages.data_ptr())
        prog = self._programs.get(key)
        if prog is None:
            if self._pool is None and self.device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
            prog = self._programs[key] = _Program(
                body, pages, ins, self.device, self._pool)
        return prog

    # -- shared forward pieces -----------------------------------------

    def _ln(self, x, name):
        p = self.params
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * p[f"{name}.scale"] \
            + p[f"{name}.bias"]

    def _linear(self, x, name):
        return x @ self.params[f"{name}.w"] + self.params[f"{name}.b"]

    def _mlp(self, x, ln):
        h = F.gelu(self._linear(x, f"{ln}.mlp.fc_in"), approximate="none")
        return self._linear(h, f"{ln}.mlp.fc_out")

    # -- prefill --------------------------------------------------------

    def bucket_for(self, prompt_len: int) -> Optional[int]:
        for b in self.prefill_buckets:
            if prompt_len <= b:
                return b
        return None

    def _bucket_or_raise(self, n: int) -> int:
        L = self.bucket_for(n)
        if L is None:
            raise _errors.errors.InvalidArgument(
                f"prompt of {n} tokens exceeds the largest prefill "
                f"bucket {self.prefill_buckets[-1]}")
        return L

    def _prompt_trunk(self, tokens: torch.Tensor, L: int, on_kv=None):
        """The full-prompt causal transformer forward shared by prefill
        and scoring: [1, L] tokens -> final-LN hidden states [1, L, D].
        ``on_kv(layer, k, v)`` observes each layer's K/V ([1, L, H, hd])
        -- prefill scatters them into the request's KV blocks; scoring
        keeps nothing."""
        cfg, p = self.cfg, self.params
        H, hd = cfg.n_head, cfg.head_dim
        scale = 1.0 / math.sqrt(hd)
        pos = torch.arange(L, device=self.device)
        x = p["gpt.wte"][tokens] + p["gpt.wpe"][pos][None]  # [1,L,D]
        causal = pos[:, None] >= pos[None, :]
        for i in range(cfg.n_layer):
            ln = f"gpt.h{i}"
            h = self._ln(x, f"{ln}.ln1")
            q = self._linear(h, f"{ln}.attn.q").reshape(1, L, H, hd)
            k = self._linear(h, f"{ln}.attn.k").reshape(1, L, H, hd)
            v = self._linear(h, f"{ln}.attn.v").reshape(1, L, H, hd)
            if on_kv is not None:
                on_kv(i, k, v)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
            s = s.masked_fill(~causal[None, None], _NEG)
            a = torch.softmax(s, dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(1, L, -1)
            x = x + self._linear(o, f"{ln}.attn.proj")
            x = x + self._mlp(self._ln(x, f"{ln}.ln2"), ln)
        return self._ln(x, "gpt.lnf")

    @torch.no_grad()
    def prefill(self, pages: torch.Tensor, tokens: np.ndarray, length: int,
                block_ids: Sequence[int]):
        """Run the prompt through the smallest bucket that holds it,
        writing its K/V into ``pages`` in place. Returns
        (pages, first_token:int). Raises InvalidArgument when no bucket
        fits (the engine fails the request, not the batch)."""
        n = int(length)
        L = self._bucket_or_raise(n)
        BS = self.block_size
        padded = np.zeros((1, L), np.int64)
        padded[0, :n] = np.asarray(tokens, np.int64)[:n]
        ids = np.zeros((self.max_blocks_per_req,), np.int64)
        blocks = list(block_ids)[:self.max_blocks_per_req]
        ids[:len(blocks)] = blocks
        # padded positions all write scratch block 0, slot 0 (duplicate
        # writes there leave an arbitrary winner, which nothing reads)
        pos = np.arange(L)
        blk = np.where(pos < n, ids[pos // BS], 0)
        slot = np.where(pos < n, pos % BS, 0)
        tok = self._run(("prefill", L), self._prefill_body, pages,
                        tokens=padded, blk=blk, slot=slot, last=[(n - 1) % L])
        return pages, int(tok)

    def _prefill_body(self, pages, tokens, blk, slot, last):
        """Prefill on device inputs: the [1, L] padded prompt, each
        position's block and slot, and the last prompt position [1].
        Returns the first token (0-d)."""

        def scatter_kv(i, k, v):
            pages[i, 0, blk, slot] = k[0]
            pages[i, 1, blk, slot] = v[0]

        x = self._prompt_trunk(tokens, tokens.shape[1], on_kv=scatter_kv)
        h = x[0].index_select(0, last)[0]  # [D], indexed on the device
        return torch.argmax(h @ self.params["gpt.wte"].t())

    # -- prompt scoring -------------------------------------------------

    @torch.no_grad()
    def score(self, tokens, length: Optional[int] = None):
        """Per-token NLL of a prompt (the scoring API): returns
        (nll[np, length-1], total_nll). Runs at the smallest prefill
        bucket that holds the prompt, like prefill itself, through the
        fused lm-head + CE kernel (the plain version on the CPU)."""
        toks = np.asarray(tokens, np.int64).reshape(-1)
        n = int(length) if length is not None else int(toks.size)
        L = self._bucket_or_raise(n)
        padded = np.zeros((1, L), np.int64)
        padded[0, :n] = toks[:n]
        nll, total = self._run(("score", L), self._score_body, None,
                               tokens=padded, count=[n])
        return nll.cpu().numpy()[:max(0, n - 1)], float(total)

    def _score_body(self, pages, tokens, count):
        """Scoring on device inputs: the [1, L] padded prompt and its
        length [1]. Returns (nll [L - 1], padded tail zeroed; its sum)."""
        L = tokens.shape[1]
        x = self._prompt_trunk(tokens, L)
        # positions 0..L-2 predict tokens 1..L-1; padded tail masked
        nll = lmhead_ce(x[0, :L - 1], self.params["gpt.wte"], tokens[0, 1:])
        valid = torch.arange(L - 1, device=self.device) < (count - 1)
        nll = torch.where(valid, nll, torch.zeros_like(nll))
        return nll, nll.sum()

    # -- decode ---------------------------------------------------------

    @torch.no_grad()
    def decode(self, pages: torch.Tensor, block_tables: np.ndarray,
               context_lens: np.ndarray, tokens: np.ndarray):
        """One decode tick at max_batch, writing each slot's new K/V into
        ``pages`` in place. Inactive slots carry all-zero tables (reads
        masked, writes land in the scratch block). Returns
        (pages, next[B] np.int32)."""
        nxt = self._run("decode", self._decode_body, pages,
                        tables=block_tables, pos=context_lens, toks=tokens)
        return pages, nxt.cpu().numpy().astype(np.int32)

    def _decode_body(self, pages, tables, pos, toks):
        """A decode tick on device inputs: block tables [B, MAXB], each
        slot's new position [B] and token [B]. Returns the next tokens
        [B]."""
        cfg, p, BS = self.cfg, self.params, self.block_size
        B, H, hd = self.max_batch, cfg.n_head, cfg.head_dim
        S = self.gather_len
        scale = 1.0 / math.sqrt(hd)
        x = p["gpt.wte"][toks] + p["gpt.wpe"][pos]  # [B, D]
        blk = tables[torch.arange(B, device=self.device), pos // BS]
        slot = pos % BS
        valid = (torch.arange(S, device=self.device)[None, :]
                 <= pos[:, None])  # [B, S]
        for i in range(cfg.n_layer):
            ln = f"gpt.h{i}"
            h = self._ln(x, f"{ln}.ln1")
            q = self._linear(h, f"{ln}.attn.q").reshape(B, H, hd)
            k = self._linear(h, f"{ln}.attn.k").reshape(B, H, hd)
            v = self._linear(h, f"{ln}.attn.v").reshape(B, H, hd)
            pages[i, 0, blk, slot] = k
            pages[i, 1, blk, slot] = v
            # [B, MAXB, BS, H, hd] -> [B, S, H, hd]
            kk = pages[i, 0][tables].reshape(B, S, H, hd)
            vv = pages[i, 1][tables].reshape(B, S, H, hd)
            s = torch.einsum("bhd,bshd->bhs", q, kk) * scale
            s = s.masked_fill(~valid[:, None, :], _NEG)
            a = torch.softmax(s, dim=-1)
            o = torch.einsum("bhs,bshd->bhd", a, vv).reshape(B, -1)
            x = x + self._linear(o, f"{ln}.attn.proj")
            x = x + self._mlp(self._ln(x, f"{ln}.ln2"), ln)
        x = self._ln(x, "gpt.lnf")
        logits = x @ p["gpt.wte"].t()  # [B, V]
        return torch.argmax(logits, dim=-1)

    @torch.no_grad()
    def warm(self, full: bool = False,
             pages: Optional[torch.Tensor] = None) -> None:
        """Run decode and the smallest prefill bucket (every prefill and
        score bucket when ``full``) ahead of traffic, so the first
        request does not pay the device's one-time library and kernel
        loading. On ``pages`` (the engine's own) each program runs twice
        on the compiled route, its warm-up and its capture, so traffic
        only replays; with no pages they run once on a one-block scratch
        set. Every write of these calls lands in block 0, the scratch
        block that nothing reads, so a cache is left untouched."""
        target = pages if pages is not None else self.init_pages(n_blocks=1)
        calls = 1 + (pages is not None and replays(self.device, self.staged))
        B = self.max_batch
        buckets = (self.prefill_buckets if full
                   else self.prefill_buckets[:1])
        for _ in range(calls):
            self.decode(target, np.zeros((B, self.max_blocks_per_req)),
                        np.zeros(B), np.zeros(B))
            for L in buckets:
                self.prefill(target, np.zeros(L), L, [])
                if full:
                    self.score(np.zeros(L))
        self.synchronize()

    # -- reference path (tests) ----------------------------------------

    @torch.no_grad()
    def full_logits(self, tokens: np.ndarray) -> np.ndarray:
        """Non-paged reference forward over [1, T] -- the ground truth
        the engine's batched output is checked against."""
        t = np.asarray(tokens, np.int64).reshape(1, -1)
        x = self._prompt_trunk(self._ids(t), t.shape[1])
        return (x @ self.params["gpt.wte"].t()).float().cpu().numpy()

    # -- roofline -------------------------------------------------------

    def decode_roofline(self, mean_active: float,
                        calibration: Optional[Dict[str, float]] = None
                        ) -> Optional[Dict[str, Any]]:
        """The decode program's tokens/s ceiling from its cost record:
        per-tick lower bounds for the compute, memory and dispatch legs,
        the binding one named. The port runs eagerly and records no cost
        insight yet, so this returns None until one is installed."""
        ins = self.insights.get("decode")
        if ins is None or not ins.flops:
            return None
        calib = calibration or calibrate(device=self.device)
        legs = {
            "compute_s": float(ins.flops) / max(calib["flops_per_sec"], 1.0),
            "memory_s": (float(ins.bytes_accessed or 0)
                         / max(calib["bytes_per_sec"], 1.0)),
            "dispatch_s": float(calib["dispatch_s"]),
        }
        bound_by = max(legs, key=legs.get)
        floor = max(legs.values())
        active = max(float(mean_active), 1e-6)
        return {
            "legs": {k: round(v, 9) for k, v in legs.items()},
            "bound_by": bound_by,
            "tick_seconds_floor": round(floor, 9),
            "mean_active": round(active, 4),
            "predicted_tokens_per_sec": active / floor,
            "flops": float(ins.flops),
            "bytes_accessed": float(ins.bytes_accessed or 0),
            "calibration": {k: round(float(v), 3) if k.endswith("per_sec")
                            else float(v) for k, v in calib.items()},
            "program": ins.key_hash,
        }


class _Program:
    """One serving program on the compiled route: its static input
    buffers, the pages it is bound to (None for scoring) and its body
    run through ``replay.Captured``."""

    def __init__(self, body, pages, ins: Dict[str, torch.Tensor], device,
                 pool):
        self.pages = pages
        self.inputs = {k: torch.empty(t.shape, dtype=t.dtype, device=device)
                       for k, t in ins.items()}
        self.run = Captured(lambda replayed: body(pages, **self.inputs),
                            device, pool=pool)
