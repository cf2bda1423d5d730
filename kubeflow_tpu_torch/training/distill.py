"""Draft distillation for speculative decoding — the port of
``kubeflow_tpu/training/distill.py``.

The self-draft (the target's bottom ``n_layers // 4`` blocks and its
embeddings) accepts only what the truncated stack happens to agree with
the full stack about. This trains a small draft to imitate the target
where acceptance is scored: along the target's own greedy decode
trajectories.

1. a corpus of the TARGET's greedy continuations of random prompts
   (:func:`_decode_corpus`), the sequences speculative decoding walks;
2. the draft warm-started from the target's bottom blocks and embeddings
   (:func:`init_from_target`, the self-draft's parameters, copied);
3. ``KL(teacher || student)`` in f32 at ``kl_temperature`` over every
   corpus position (:func:`distill_loss`), minimized with Adam (optax's
   defaults: 0.9, 0.999, eps 1e-8); the teacher runs under
   ``torch.no_grad()``.

Teacher and student are ``GptLM(decode=False)`` with
``causal_flash_attention``: on the card each step launches the flash
kernels (the teacher's forward, the student's forward and backward). The
prompts come from the port's own seeded generator: JAX's
``jax.random.randint`` cannot be reproduced, so ``_decode_corpus`` takes
``prompts`` to give both packages the same ones. ``(draft_cfg,
draft_params)`` plugs into ``ContinuousBatcher(spec_draft=...)``.

With ``checkpoint_dir`` the draft is saved as JAX saves it: its flax tree
(``models.convert.params_to_flax``, f32) at step ``steps`` through the
port's ``Checkpointer``, with JAX's ``spec_draft`` meta record. Either
package reads it back: ``Checkpointer(dir).restore_numpy()`` gives the tree
and the meta, and ``params_from_flax(tree, draft_cfg)`` the port's
``spec_draft`` params.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.convert import params_to_flax
from ..models.gpt import GptConfig, GptLM, Params, generate
from ..runtime.metrics import METRICS
from .checkpoint import Checkpointer


def draft_config(cfg: GptConfig, n_layers: Optional[int] = None) -> GptConfig:
    """The draft's shape: the target's width at ``n_layers`` depth (default
    ``max(1, n_layers // 4)``, the self-draft's), with the config's other
    defaults, as JAX's ``draft_config`` builds it."""
    return GptConfig(d_model=cfg.d_model, n_layers=n_layers or max(1, cfg.n_layers // 4),
                     n_heads=cfg.n_heads, d_ff=cfg.d_ff, max_seq=cfg.max_seq,
                     vocab_size=cfg.vocab_size)


def init_from_target(draft_cfg: GptConfig, params: Params) -> Params:
    """Warm-start draft params: the target's embedding, final norm and
    bottom ``draft_cfg.n_layers`` blocks, cloned so that training the
    draft cannot touch the target."""
    keep = tuple(f"block_{i}." for i in range(draft_cfg.n_layers))
    return {k: v.detach().clone() for k, v in params.items()
            if not k.startswith("block_") or k.startswith(keep)}


def _decode_corpus(cfg: GptConfig, params: Params, *, sequences: int, prompt_len: int,
                   decode_len: int, seed: int, prompts: Optional[np.ndarray] = None,
                   device: DeviceLike = "cuda") -> np.ndarray:
    """[sequences, prompt_len + decode_len] token ids: random prompts (or
    ``prompts``) continued by the TARGET's greedy ``generate()``."""
    if prompts is None:
        gen = torch.Generator().manual_seed(int(seed))
        prompts = torch.randint(0, cfg.vocab_size, (sequences, prompt_len), generator=gen,
                                dtype=torch.int32).numpy()
    return generate(cfg, params, prompts, decode_len, device=device).cpu().numpy()


def distill_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                 temperature: float = 1.0) -> torch.Tensor:
    """KL(teacher || student) of the softmaxes at ``temperature``, in f32,
    averaged over batch × positions."""
    t = torch.log_softmax(teacher_logits.float() / temperature, dim=-1)
    s = torch.log_softmax(student_logits.float() / temperature, dim=-1)
    return (t.exp() * (t - s)).sum(dim=-1).mean()


def distill_draft(cfg: GptConfig, params: Params, draft_cfg: Optional[GptConfig] = None, *,
                  steps: int = 300, batch: int = 8, sequences: int = 32,
                  prompt_len: int = 16, decode_len: int = 48, lr: float = 1e-3,
                  kl_temperature: float = 1.0, seed: int = 0,
                  checkpoint_dir: Optional[str] = None,
                  on_step: Optional[Callable[[int, float], None]] = None,
                  device: DeviceLike = "cuda") -> Tuple[GptConfig, Params]:
    """Distill a draft from ``(cfg, params)``; returns ``(draft_cfg,
    draft_params)`` for ``spec_draft=``. Each step's rows come from
    ``np.random.default_rng(seed + 1)``, as in JAX. ``on_step(step, kl)``
    (optional) sees each step's KL, read to the host. Counts
    ``distill_steps_total`` and sets the ``distill_kl`` gauge to the last
    step's KL. ``checkpoint_dir`` (optional) receives the draft at step
    ``steps`` with JAX's ``spec_draft`` meta (see the module docstring)."""
    draft_cfg = draft_cfg or draft_config(cfg)
    if draft_cfg.vocab_size != cfg.vocab_size or draft_cfg.max_seq != cfg.max_seq:
        raise ValueError("draft must share the target's vocab and max_seq")
    dev = resolve_device(device)
    # opened before training: an unusable directory fails before any step
    ckpt = Checkpointer(checkpoint_dir) if checkpoint_dir else None
    params = {k: v.to(dev) for k, v in params.items()}
    corpus = _decode_corpus(cfg, params, sequences=sequences, prompt_len=prompt_len,
                            decode_len=min(decode_len, cfg.max_seq - prompt_len),
                            seed=seed, device=dev)
    teacher = GptLM.bind(cfg, params)
    student = GptLM.trainable(draft_cfg, init_from_target(draft_cfg, params))
    opt = torch.optim.Adam(student.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    rng = np.random.default_rng(seed + 1)
    loss = None
    for step in range(int(steps)):
        rows = rng.integers(0, corpus.shape[0], size=batch)
        ids = torch.from_numpy(corpus[rows]).to(dev)
        with torch.no_grad():
            teacher_logits = teacher(ids)
        loss = distill_loss(student(ids), teacher_logits, float(kl_temperature))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        METRICS.counter("distill_steps_total").inc()
        if on_step is not None:
            on_step(step, loss.item())
    final_kl = loss.item() if loss is not None else 0.0
    METRICS.gauge("distill_kl").set(final_kl)
    draft_params = {k: v.detach() for k, v in student.state_dict().items()}
    if ckpt is not None:
        meta = {
            "kind": "spec_draft",
            "distilled_from": {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
                               "vocab_size": cfg.vocab_size},
            "draft_layers": draft_cfg.n_layers,
            "steps": int(steps), "lr": lr, "seed": seed,
            "final_kl": round(final_kl, 6),
        }
        ckpt.save(int(steps), params_to_flax(draft_params, draft_cfg), meta=meta)
    return draft_cfg, draft_params


def measure_accept_rate(cfg: GptConfig, params: Params, draft_cfg: GptConfig,
                        draft_params: Params, *, n_requests: int = 8, prompt_len: int = 16,
                        budget: int = 32, spec_k: int = 4, slots: int = 4, seed: int = 100,
                        device: DeviceLike = "cuda") -> float:
    """Serve greedy requests through a speculative engine and return the
    accept rate (accepted / drafted, from the serving counters). Prompt
    ``i`` is drawn by ``np.random.default_rng(seed + i)``."""
    from ..serving.continuous import ContinuousBatcher

    drafted0 = METRICS.value("serving_spec_tokens_drafted_total")
    accepted0 = METRICS.value("serving_spec_tokens_accepted_total")
    eng = ContinuousBatcher(cfg, params, slots=slots, spec_draft=(draft_cfg, draft_params),
                            spec_k=spec_k, device=device)
    try:
        prompts = [np.random.default_rng(seed + i).integers(0, cfg.vocab_size, prompt_len)
                   .astype(np.int32) for i in range(n_requests)]
        futs = [eng.submit(p, budget) for p in prompts]
        for f in futs:
            f.result(timeout=600)
    finally:
        eng.close()
    drafted = METRICS.value("serving_spec_tokens_drafted_total") - drafted0
    accepted = METRICS.value("serving_spec_tokens_accepted_total") - accepted0
    return accepted / drafted if drafted else 0.0
