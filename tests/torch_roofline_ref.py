"""The dot FLOPs of the port's built steps (``repro_torch.roofline``,
counted on fake tensors) against the reference's ``analyze_hlo_text`` of
the same functions, for ``tests/test_torch_roofline*.py`` (four files,
each under 30 s alone on the CPU).

For an arch at its reduced width: the train step (the loss and its
gradient; the port's whole built step, whose optimizer adds no product),
the prefill and one decode step. The reference's functions are jitted on
the CPU without a mesh (its meshed path fails there, ROADMAP.md queue 3)
and compiled; the port's are built on a fake (1, 1) mesh. Where the two
run the same einsums the counts are equal; ``expected_gap`` gives the
reference's surplus where they do not, each with its cause, and the
tests pin each with a witness. JAX is imported inside the functions.
"""
import torch

from repro_torch.configs import build_model, get_config
from repro_torch.configs.registry import ShapeSpec
from repro_torch.launch import steps
from repro_torch.roofline import count_step, fake_world

B, S, T = 2, 16, 32   # batch, prompt and train length, decode cache slots
DECODE_POS = T - 4
KINDS = ("train", "prefill", "decode")


def shape(kind: str) -> ShapeSpec:
    return {"train": ShapeSpec("t", S, B, "train"), "prefill": ShapeSpec("p", S, B, "prefill"),
            "decode": ShapeSpec("d", T, B, "decode")}[kind]


def ref_flops(arch: str, kind: str) -> float:
    """The reference's dot FLOPs of ``kind`` (``analyze_hlo_text`` of the
    compiled jitted function, loops multiplied by their trip counts)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config
    from repro.roofline.hlo_cost import analyze_hlo_text

    m = jax_build(jax_config(arch, reduced=True))
    p = m.init(0)
    batch = {"tokens": jnp.zeros((B, S), jnp.int32)}
    whisper = hasattr(m.cfg, "enc_layers")
    if whisper:
        batch["enc_embeds"] = jnp.zeros((B, S, m.cfg.d_model), jnp.bfloat16)
    if getattr(m.cfg, "mrope", False):
        batch["positions3"] = jnp.zeros((3, B, S), jnp.int32)
    if kind == "train":
        fn, args = jax.grad(lambda p, b: jnp.sum(m.loss(p, b)[0])), (p, batch)
    elif kind == "prefill":
        fn, args = m.prefill, (p, batch)
    else:
        cache = m.init_cache(B, T, T) if whisper else m.init_cache(B, T)
        step = {"token": jnp.zeros((B, 1), jnp.int32), "pos": jnp.asarray(DECODE_POS, jnp.int32)}
        fn, args = m.decode_step, (p, cache, step)
    return analyze_hlo_text(jax.jit(fn).lower(*args).compile().as_text()).flops


def port_flops(arch: str, kind: str) -> float:
    """The port's dot FLOPs of its built ``kind`` step on a fake (1, 1) mesh."""
    with fake_world((1, 1)) as mesh:
        model = build_model(get_config(arch, reduced=True), device="cpu")
        return count_step(steps.build_step(model, mesh, shape(kind))).flops


def meshless_flops(arch: str, kind: str) -> float:
    """The port's dot FLOPs of the model's own step outside any mesh
    context (MoE: the grouped path, as the reference jitted without a
    mesh runs it): ``loss`` and its gradient, ``prefill``, or
    ``decode_step``."""
    from repro_torch.roofline.cost import counting
    from repro_torch.tree import tree_leaves, tree_unflatten

    with fake_world((1, 1)):
        model = build_model(get_config(arch, reduced=True), device="cpu")
        tokens = torch.zeros((B, S), dtype=torch.int32)
        with counting() as mode:
            if kind == "train":
                params = model.params()
                alias = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
                per_ex, _ = model.loss(tree_unflatten(params, alias), {"tokens": tokens})
                torch.autograd.grad(per_ex.sum(), alias, allow_unused=True)
            elif kind == "prefill":
                model.prefill({"tokens": tokens})
            else:
                model.decode_step(model.init_cache(B, T), {
                    "token": torch.zeros((B, 1), dtype=torch.int32), "pos": DECODE_POS})
        return mode.cost.flops


def _blocks(cfg, kind: str):
    return [b for g in cfg.groups for b in (g.blocks + g.shared) * g.repeat if b.kind == kind]


def moe_combine_flops(arch: str, tokens: int) -> float:
    """The reference's combine einsum ``gtkd,gtk->gtd`` over ``tokens``
    tokens, every MoE layer: 2 T K D each."""
    return sum(2.0 * tokens * b.moe.top_k * b.moe.d_model
               for b in _blocks(get_config(arch, reduced=True), "moe"))


def expected_gap(arch: str, kind: str) -> float:
    """The reference's dot FLOPs minus the port's built step's, with its
    cause:
    - MoE (granite-moe, deepseek-v2-lite): the built steps run the mesh
      path, whose combine is a weighted sum of each choice's row in
      float32 (no product), while the reference jitted without a mesh runs
      the grouped path's einsum ``gtkd,gtk->gtd``; in the train step its
      HLO keeps two of that einsum's three products (the forward and one
      gradient) as dots.
    - zamba2 train: one product of 2 B S d_inner FLOPs a Mamba2 block in
      the backward pass, a dot in the reference's HLO and elementwise in
      the port's autograd (the forward steps count the same; the product
      is a gradient of the scan's activations, not of a parameter:
      stopping the gradients of D, A_log, dt_bias or the convolution
      leaves the reference's count as it is).
    - rwkv6 decode: the reference's bonus term
      ``einsum("bhk,hk,bhk,bhv->bhv")`` holds a dot contracting K (2 B H K
      a time-mix block), the port's ``(r u k).sum(-1) v`` is elementwise.
    0 elsewhere."""
    cfg = get_config(arch, reduced=True)
    if not hasattr(cfg, "groups"):  # whisper
        return 0.0
    if _blocks(cfg, "moe"):
        return {"train": 2 * moe_combine_flops(arch, B * S),
                "prefill": moe_combine_flops(arch, B * S),
                "decode": moe_combine_flops(arch, B)}[kind]
    if kind == "train" and _blocks(cfg, "mamba2"):
        return sum(2.0 * B * S * b.mamba.d_inner for b in _blocks(cfg, "mamba2"))
    if kind == "decode" and _blocks(cfg, "rwkv6_time"):
        return sum(2.0 * B * b.rwkv.d_model for b in _blocks(cfg, "rwkv6_time"))
    return 0.0
