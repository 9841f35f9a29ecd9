"""Serving launcher: continuous batching over synthetic requests on the
paged KV cache (or an ssm model's per-slot recurrent state), with the
hand-written kernels on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 8 --slots 4 --page-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen2-moe-a2.7b --slots 8 --page-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-20b --slots 8 --page-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen1.5-32b --slots 8 --page-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch rwkv6-7b --slots 8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch zamba2-7b --slots 8 --page-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-v3-671b --layers 5 --slots 8 --page-tokens 16

Every ported architecture serves through the same path (``--arch``):
qwen2-0.5b, dense; qwen2-moe-a2.7b, MoE, whose expert FFNs run through
the expert-grouped streaming GEMM; internvl2-2b, the vlm family's
language model (served from token prompts; ``Model.prefill`` also takes
precomputed patch embeddings); chatglm3-6b, 2-D RoPE; granite-20b,
layernorm, a non-gated GELU MLP and MQA (48 query heads over one KV
head, which the paged kernel splits into query-head groups);
qwen1.5-32b, 64 layers of 40 / 40 heads (70.4 GB of weights);
rwkv6-7b, attention-free (ssm): each layer's RWKV6 time and channel mix
over a fixed recurrent state per slot, no KV pool (``--page-tokens``
unused), every projection through the streaming GEMM; zamba2-7b,
hybrid: 81 Mamba2 layers over a per-slot recurrent state and one shared
attention block (32 / 32 heads of 112) run before every sixth layer,
whose 14 invocations keep their K/V in a paged pool of 14 layers
(flash attention at prefill, paged attention at decode);
deepseek-v3-671b, multi-head latent attention (flash at q/k dim 192, v
dim 128 at prefill; the absorbed decode over one latent pool per layer
of 576-wide rows) with 256 routed experts, top-8, which one card holds
only cut in depth: ``--layers 5`` keeps the 3 dense and 2 MoE layers
(51.8 GB) at full width.  ``--layers N`` cuts any config to its first N
layers.  The
encoder-decoder whisper-tiny is refused by the engine, as in the
reference: it runs through ``Model.prefill(..., audio_frames=...)`` and
``Model.decode_step``.

Weights are random, drawn from ``--seed``.  ``--device cpu`` runs the
plain PyTorch versions of the kernels on the host (use ``--reduced``
there).
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import depth_cut
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServingEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--page-tokens", type=int, default=8)
    ap.add_argument("--layers", type=int, default=0,
                    help="serve only the first N layers (0: all)")
    args = ap.parse_args()

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.layers:
        cfg = depth_cut(cfg, args.layers)
    model = Model(cfg, device=args.device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    eng = ServingEngine(cfg, params, slots=args.slots,
                        max_seq=args.max_seq, device=args.device,
                        kv_page_tokens=args.page_tokens)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        r = Request(uid=i,
                    prompt=rng.integers(1, cfg.vocab_size - 1,
                                        int(rng.integers(4, 16))
                                        ).astype(np.int32),
                    max_new_tokens=args.new_tokens)
        reqs.append(r)
        eng.submit(r)
    st = eng.run_until_drained()
    ttft = [r.first_token_s - r.submitted_s for r in reqs]
    where = torch.cuda.get_device_name(model.device) \
        if model.device.type == "cuda" else "cpu"
    print(f"[{cfg.name} on {where}] {st.tokens_out} tokens "
          f"@ {st.tokens_per_s:.1f} tok/s; "
          f"TTFT p50={np.percentile(ttft, 50)*1e3:.0f}ms; "
          f"prefills={st.prefills} decode_steps={st.decode_steps}")


if __name__ == "__main__":
    main()
