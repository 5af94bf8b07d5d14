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
as the reference computes them without a kernel.

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
    python -m repro_torch.serve_lm --device cpu --reduced  # anywhere
    python -m repro_torch.serve_lm --arch rwkv6-7b --device cpu --reduced
    python -m repro_torch.serve_lm --arch deepseek-v2-lite-16b --device cpu --reduced
    python -m repro_torch.serve_lm --arch gemma3-1b --device cpu --reduced
    python -m repro_torch.serve_lm --arch zamba2-1.2b --device cpu --reduced
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, build_model, get_config


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_tokens(vocab: int, batch: int, prompt_len: int, seed: int) -> torch.Tensor:
    """A (batch, prompt_len) int32 prompt drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (batch, prompt_len), dtype=np.int32))


def generate(model, tokens: torch.Tensor, n_new: int) -> Dict[str, object]:
    """Prefill ``tokens`` (B, P), then decode greedily until each sequence
    has ``n_new`` new tokens (the first from the prefill's logits, then
    n_new - 1 decode steps at pos P, P+1, ...). Returns the new tokens
    (B, n_new) int32 on the host, the prefill's and the first decode step's
    logits (B, 1, V) bf16, the cache, and the prefill and decode wall times
    (host clock around work ended by a device synchronize)."""
    if n_new < 1:
        raise ValueError("n_new must be at least 1")
    dev = model.device
    B, P = tokens.shape
    tokens = tokens.to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": tokens, "cache_len": P + n_new})
    tok = logits[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out = [tok]
    first_step = None
    pos = torch.tensor(P, dtype=torch.int32, device=dev)  # advanced on the device
    t0 = time.perf_counter()
    for _ in range(n_new - 1):
        step_logits, cache = model.decode_step(cache, {"token": tok, "pos": pos})
        tok = step_logits[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
        out.append(tok)
        first_step = step_logits if first_step is None else first_step
        pos += 1
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return {
        "tokens": torch.cat(out, dim=1).cpu(), "prefill_logits": logits,
        "first_step_logits": first_step, "cache": cache, "prefill_s": prefill_s,
        "decode_s": decode_s,
    }


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--reduced", action="store_true", help="the arch's reduced config")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without one) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and the prompt")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg, device=args.device, seed=args.seed)
    prompt = prompt_tokens(cfg.vocab, args.batch, args.prompt_len, args.seed)
    res = generate(model, prompt, args.tokens)
    B, P, n = args.batch, args.prompt_len, args.tokens
    steps = n - 1
    print(f"{cfg.name} on {model.device}: {model.num_params():,} parameters")
    print(f"prefill {B}x{P}: {res['prefill_s']:.4f} s, {B * P / res['prefill_s']:.1f} tokens/s")
    if steps:
        print(f"decode {steps} steps x {B} sequences: {res['decode_s'] / steps * 1e3:.3f} ms/step, "
              f"{B * steps / res['decode_s']:.1f} tokens/s")
    print("first sequence:", res["tokens"][0, :16].tolist(), "...")
    return res


if __name__ == "__main__":
    main()
