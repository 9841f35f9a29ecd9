"""Serving launcher: continuous batching over synthetic requests on the
paged KV cache, with the hand-written kernels on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 8 --slots 4 --page-tokens 16

Weights are random, drawn from ``--seed``.  ``--device cpu`` runs the
plain PyTorch versions of the kernels on the host (use ``--reduced``
there).
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
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
    args = ap.parse_args()

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
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
