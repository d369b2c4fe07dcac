"""Serving: a batch of prompts -> prefill (cache fill) -> greedy decode
loop, one token per step.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \\
        --batch 4 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek-moe-16b --batch 4 --prompt-len 4096 --gen 8
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch zamba2-7b --batch 4 --prompt-len 4096 --gen 8
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch rwkv6-3b --batch 4 --prompt-len 4096 --gen 8

On the card, a prefill whose prompt length is a multiple of 128 runs its
attention through the flash-attention kernel (``kernels.ops.attention``,
one launch per layer); decode steps attend over the cache in plain
PyTorch. An MoE model (deepseek-moe-16b, arctic-480b) runs its experts
through the ``gmm`` kernel (``kernels.ops.grouped_matmul``, three launches
per layer) where the expert capacity C, d_model and the expert d_ff are
multiples of 128: for deepseek-moe-16b a prefill of 16,384 tokens
(C 1,920), such as 4 x 4096; other token counts, and every decode step,
take ``torch.einsum``, as the JAX package does. The hybrid zamba2-7b
runs each of its 81 Mamba2 blocks' scan through the ``ssd_scan`` kernel
(``kernels.ops.ssd``, chunk ``min(256, S)``: S must be a multiple of it)
and its shared attention, 9 applications, through the flash kernel where
S is a multiple of 128: a 4 x 4096 prefill runs 81 ``ssd_scan`` and 9
flash launches. Its decode steps are plain PyTorch (the recurrent Mamba2
step on the float32 state). The RWKV6 model rwkv6-3b serves as the JAX
package serves it: its prefill runs the chunked WKV scan ``wkv_chunked`` in
plain PyTorch from the cache's state (at chunk ``min(64, S)``, the prompt
padded to a multiple of it), and leaves the state in the compute type;
its decode steps run the O(1) recurrence. Neither launches the
``wkv6_scan`` kernel, which runs in the full-sequence forward
(``models.forward``, the scoring and loss path). The weights are random
(``init_params`` from ``--seed``).
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import init_params, model_defs
from repro_torch.models.base import ArchConfig
from repro_torch.training.steps import make_decode_step, make_prefill_step


class ServeResult(NamedTuple):
    tokens: torch.Tensor           # [B, gen] greedy tokens, int64
    prefill_logits: torch.Tensor   # [B, 1, V] logits of the prompt's last token
    # k, v [L, B, S + gen, Kv, Dh]; the hybrid family's state, conv_x,
    # conv_bc [L, B, ...] and attn_k, attn_v [L / every, B, S + gen, Kv, Dh];
    # the ssm family's state [L, B, H, c, c], tm_last, cm_last [L, B, D]
    cache: dict
    prefill_seconds: float         # host clock, prefill and its first token
    decode_seconds: float          # host clock, the gen - 1 decode steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ArchConfig, prompts, gen: int, *, params=None, seed: int = 0,
          attn_impl: str = "auto", device=None) -> ServeResult:
    """Greedy generation of ``gen`` tokens after each prompt of ``prompts``
    (``[B, S]`` token ids). ``params`` default to ``init_params`` from a
    ``torch.Generator`` seeded with ``seed`` on the device. ``attn_impl``
    is the prefill's attention (``"auto"``: flash attention where the
    shapes allow; ``"ref"``: the plain attention). Runs on ``cuda`` unless
    ``device`` says otherwise, and raises without a card."""
    device = resolve_device(device)
    if params is None:
        generator = torch.Generator(device=device).manual_seed(seed)
        params = init_params(model_defs(cfg), generator, device)
    prompts = torch.as_tensor(prompts, device=device)
    B, S = prompts.shape
    prefill_fn = make_prefill_step(cfg, B, S + gen, attn_impl)
    decode_fn = make_decode_step(cfg)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill_fn(params, prompts)
    prefill_logits = logits
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = [tok]
    _sync(device)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = decode_fn(params, tok, cache, S + i)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return ServeResult(torch.cat(out, dim=1), prefill_logits, cache,
                       t_prefill, t_decode)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="yi-9b", choices=configs.ARCH_NAMES)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    device = resolve_device(args.device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    prompts = torch.randint(1, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=generator, device=device)
    res = serve(cfg, prompts, args.gen, seed=args.seed, device=device)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"generated={res.tokens.shape[1]} device={device}")
    print(f"prefill: {res.prefill_seconds * 1e3:.1f} ms; decode: "
          f"{res.decode_seconds / max(1, args.gen - 1) * 1e3:.2f} ms/token")
    print("first sequence:", res.tokens[0].tolist())


if __name__ == "__main__":
    main()
