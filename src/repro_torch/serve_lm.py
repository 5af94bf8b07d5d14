"""Serve an LM of ``ARCH_IDS``: batched prefill, then greedy decode from
the cache.

The port's counterpart of ``examples/serve_lm.py``. Weights are random,
drawn from ``--seed``; so is the prompt (numpy). On CUDA every layer with a
kernel runs it: in a dense LM, in gemma3-1b (head_dim 256; its local
layers over a 512-key window, their caches 512-slot rings), in
granite-moe's attention and in zamba2-1.2b's shared attention, flash
attention in the prefill and flash-decode in every decode step; in
rwkv6-7b, the linear-scan kernel in each time-mix layer of the prefill
(decode is one recurrent step in plain PyTorch, as in the reference). MoE
layers, deepseek-v2-lite's MLA and zamba2's Mamba2 blocks (the chunked
SSD scan in the prefill, one recurrent step in decode) are plain PyTorch,
as the reference computes them without a kernel. qwen2-vl-72b rotates with
M-RoPE: the prompt's positions3 are the token positions on all three
components unless ``generate`` is given others. whisper-base encodes frame
embeddings drawn from ``--seed`` (``--enc-len`` frames, the prompt length
by default): the encoder's self-attention and the decoder's
cross-attention run the flash kernel in the prefill (the cross-attention
with the prompt's rows against every frame), and the decoder's self- and
cross-attention the flash-decode kernel in every step.

    python -m repro_torch.serve_lm --arch internlm2-1.8b --batch 4 \\
        --prompt-len 4096 --tokens 256                     # on a GPU
    python -m repro_torch.serve_lm --arch rwkv6-7b --batch 4 \\
        --prompt-len 4096 --tokens 128                     # on a GPU
    python -m repro_torch.serve_lm --arch granite-moe-3b-a800m --batch 4 \\
        --prompt-len 4096 --tokens 128                     # on a GPU
    python -m repro_torch.serve_lm --arch deepseek-v2-lite-16b --batch 4 \\
        --prompt-len 4096 --tokens 64                      # on a GPU
    python -m repro_torch.serve_lm --arch gemma3-1b --batch 4 \\
        --prompt-len 4096 --tokens 128                     # on a GPU
    python -m repro_torch.serve_lm --arch zamba2-1.2b --batch 4 \\
        --prompt-len 4096 --tokens 128                     # on a GPU
    python -m repro_torch.serve_lm --arch whisper-base --batch 16 \\
        --prompt-len 4 --enc-len 1500 --tokens 128         # on a GPU
    python -m repro_torch.serve_lm --arch qwen2-vl-72b --batch 4 \\
        --prompt-len 4096 --tokens 128   # on GPUs holding its 145 GB of bf16 weights
    python -m repro_torch.serve_lm --device cpu --reduced  # anywhere
    python -m repro_torch.serve_lm --arch rwkv6-7b --device cpu --reduced
    python -m repro_torch.serve_lm --arch deepseek-v2-lite-16b --device cpu --reduced
    python -m repro_torch.serve_lm --arch gemma3-1b --device cpu --reduced
    python -m repro_torch.serve_lm --arch zamba2-1.2b --device cpu --reduced
    python -m repro_torch.serve_lm --arch whisper-base --device cpu --reduced
    python -m repro_torch.serve_lm --arch qwen2-vl-72b --device cpu --reduced
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, build_model, get_config
from repro_torch.launch.steps import DecodeGraph
from repro_torch.models.whisper import WhisperConfig


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_tokens(vocab: int, batch: int, prompt_len: int, seed: int) -> torch.Tensor:
    """A (batch, prompt_len) int32 prompt drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (batch, prompt_len), dtype=np.int32))


def frame_embeds(d_model: int, batch: int, enc_len: int, seed: int) -> torch.Tensor:
    """(batch, enc_len, d_model) bfloat16 frame embeddings drawn with numpy
    (standard normal) from ``seed``: the stub of whisper's audio frontend."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, enc_len, d_model), dtype=np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def image_positions3(batch: int, length: int, text_before: int, grid: tuple) -> torch.Tensor:
    """(3, batch, length) int32 M-RoPE positions (t, h, w) of a prompt that
    holds one image, by Qwen2-VL's rule: ``text_before`` text tokens at
    0, 1, ... on all three components; the image's gh x gw patches
    (row-major) at t = o, h = o + row, w = o + column, with o =
    ``text_before``; the text after it at o + max(gh, gw), one more a
    token."""
    gh, gw = grid
    o = text_before
    n_text = length - o - gh * gw
    if n_text < 0:
        raise ValueError(f"a {gh}x{gw} image after {o} tokens does not fit in {length}")
    rows, cols = np.divmod(np.arange(gh * gw), gw)
    after = o + max(gh, gw) + np.arange(n_text)
    text = np.arange(o)
    p3 = np.stack([np.concatenate([text, np.full(gh * gw, o), after]),
                   np.concatenate([text, o + rows, after]),
                   np.concatenate([text, o + cols, after])]).astype(np.int32)
    return torch.from_numpy(p3)[:, None].expand(3, batch, length).contiguous()


def request_inputs(cfg, batch: int, length: int, seed: int, enc_len: Optional[int] = None,
                   image: Optional[tuple] = None, device="cpu") -> Dict[str, torch.Tensor]:
    """A request batch's inputs besides its (batch, length) tokens, on
    ``device``, as ``generate`` takes them: an encoder-decoder's
    ``enc_embeds`` (``frame_embeds`` of ``enc_len`` frames, the prompt
    length by default, from ``seed``); with ``image`` = (text tokens before
    it, its patch grid), an M-RoPE model's ``positions3``
    (``image_positions3``); nothing else (a model without M-RoPE ignores
    ``image``, and an M-RoPE prompt without one takes its token positions)."""
    if isinstance(cfg, WhisperConfig):
        return {"enc_embeds": frame_embeds(cfg.d_model, batch, enc_len or length,
                                           seed).to(device)}
    if cfg.mrope and image is not None:
        return {"positions3": image_positions3(batch, length, *image).to(device)}
    return {}


def greedy(out: torch.Tensor, P: int, kept: Optional[torch.Tensor] = None) -> Callable:
    """The greedy tail of a decode step after a P-token prompt, as
    ``DecodeGraph``'s ``after``: the step's token (the argmax of its logits)
    into column pos - P + 1 of ``out`` (B, n_new) int32 and into the next
    step's input, its logits into row pos - P of ``kept`` if given, and pos
    + 1; all on the device, indexed by the device's pos (so a graph of the
    step replays at every position)."""
    def after(step_logits: torch.Tensor, g) -> None:
        nxt = step_logits[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
        out.index_copy_(1, (g.pos - (P - 1)).long().reshape(1), nxt)
        if kept is not None:
            kept.index_copy_(0, (g.pos - P).long().reshape(1), step_logits[None])
        g.token.copy_(nxt)
        g.pos.add_(1)

    return after


def generate(model, tokens: torch.Tensor, n_new: int, enc_embeds: Optional[torch.Tensor] = None,
             positions3: Optional[torch.Tensor] = None, graph: bool = True,
             keep_logits: bool = False) -> Dict[str, object]:
    """Prefill ``tokens`` (B, P), then decode greedily until each sequence
    has ``n_new`` new tokens (the first from the prefill's logits, then
    n_new - 1 decode steps at pos P, P+1, ...). ``enc_embeds`` (B, S_enc, d)
    go to an encoder-decoder's encoder; ``positions3`` (3, B, P) are an
    M-RoPE model's prompt positions (decode positions stay the cache slot,
    on all three components, as in the reference).

    A decode step is ``model.decode_step``, the greedy argmax, the token's
    write into a (B, n_new) int32 buffer on the device and ``pos += 1``
    (``launch.steps.DecodeGraph`` with ``greedy``). With ``graph`` (the
    default) on a CUDA device, the first step runs eagerly as the warm-up,
    then one step is captured into a CUDA graph and every later step is one
    replay of it: the counterpart of the reference's jitted
    ``decode_step``. The graph
    and its memory pool are freed before this returns. ``graph=False``
    runs every step eagerly (the same work, for comparisons); on the CPU
    every step runs eagerly either way. The model runs meshless (an MoE
    layer's grouped path).

    Returns the new tokens (B, n_new) int32 on the host, the prefill's and
    the first decode step's logits (B, 1, V) bf16 (a copy), with
    ``keep_logits`` every decode step's logits (n_new - 1, B, 1, V) on the
    device, the cache, the prefill and decode wall times (host clock around
    work ended by a device synchronize; the decode time counts the eager
    first step and leaves out the capture), the capture's seconds, the
    graph's replays and its kernel launches a replay (wrapper -> count)."""
    if n_new < 1:
        raise ValueError("n_new must be at least 1")
    dev = model.device
    B, P = tokens.shape
    batch = {"tokens": tokens.to(dev), "cache_len": P + n_new}
    for key, x in (("enc_embeds", enc_embeds), ("positions3", positions3)):
        if x is not None:
            batch[key] = x.to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch)
    out = torch.empty((B, n_new), dtype=torch.int32, device=dev)
    out[:, :1] = logits[:, -1].argmax(dim=-1, keepdim=True)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    steps = n_new - 1
    kept = (torch.empty((steps, B, 1, logits.shape[-1]), dtype=logits.dtype, device=dev)
            if keep_logits else None)
    first_step, capture_s, replays, launches = None, 0.0, 0, {}
    t0 = time.perf_counter()
    if steps:
        dg = DecodeGraph(model, cache, out[:, :1], P, after=greedy(out, P, kept),
                         use_graph=graph and steps > 1)
        first_step = dg.step().clone()
        for _ in range(steps - 1):
            dg.step()
        _sync(dev)
        capture_s, replays, launches = dg.capture_s, dg.replays, dg.launches
        dg.close()
    _sync(dev)
    decode_s = time.perf_counter() - t0 - capture_s
    return {
        "tokens": out.cpu(), "prefill_logits": logits, "first_step_logits": first_step,
        "step_logits": kept, "cache": cache, "prefill_s": prefill_s, "decode_s": decode_s,
        "capture_s": capture_s, "graph_replays": replays, "graph_launches": launches,
    }


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--enc-len", type=int, default=None,
                    help="whisper: encoder frames (default: the prompt length)")
    ap.add_argument("--reduced", action="store_true", help="the arch's reduced config")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without one) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and the prompt")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg, device=args.device, seed=args.seed)
    prompt = prompt_tokens(cfg.vocab, args.batch, args.prompt_len, args.seed)
    extra = request_inputs(cfg, args.batch, args.prompt_len, args.seed, enc_len=args.enc_len,
                           device=model.device)
    res = generate(model, prompt, args.tokens, **extra)
    B, P, n = args.batch, args.prompt_len, args.tokens
    steps = n - 1
    print(f"{cfg.name} on {model.device}: {model.num_params():,} parameters")
    print(f"prefill {B}x{P}: {res['prefill_s']:.4f} s, {B * P / res['prefill_s']:.1f} tokens/s")
    if steps:
        print(f"decode {steps} steps x {B} sequences: {res['decode_s'] / steps * 1e3:.3f} ms/step, "
              f"{B * steps / res['decode_s']:.1f} tokens/s")
    if res["graph_replays"]:
        print(f"decode graph: captured in {res['capture_s']:.3f} s, "
              f"{res['graph_replays']} replays")
    print("first sequence:", res["tokens"][0, :16].tolist(), "...")
    return res


if __name__ == "__main__":
    main()
