"""Train a small LM and decode from it six ways — the serving tour of the
port, counterpart of ``examples/generate_text.py``.

Trains a TransformerLM to memorize a periodic token stream with the sync
data-parallel trainer, then continues prompts with each decoding recipe:

  1. generate       — the fixed-buffer recipe (slides past max_len)
  2. generate_fast  — KV-cached: one prefill chunk, then one tick a token
  3. generate_batch — N prompts through the same loop
  4. beam_search    — the best-scoring continuation with K beams
  5. generate_speculative — a smaller draft proposes, the target
     verifies; the output equals generate_fast's for any draft
  6. Server         — continuous batching (requests arrive and finish at
     any time; results equal the solo calls)

Usage:  python mpit_tpu_torch/examples/generate_text.py [--steps 150]
        [--device cpu]   (the card by default)
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import mpit_tpu_torch  # noqa: E402
from mpit_tpu_torch.models import (  # noqa: E402
    Server,
    beam_search,
    generate,
    generate_batch,
    generate_fast,
    generate_speculative,
)
from mpit_tpu_torch.models.transformer import TransformerLM  # noqa: E402
from mpit_tpu_torch.optim import Adam  # noqa: E402
from mpit_tpu_torch.parallel.sync import DataParallelTrainer  # noqa: E402

V, T = 17, 32


def _train(model, seed, x, y, steps, topo):
    trainer = DataParallelTrainer(model, Adam(3e-3), topo)
    state = trainer.init_state(torch.Generator().manual_seed(seed))
    xt = torch.from_numpy(x).to(topo.device)
    yt = torch.from_numpy(y).to(topo.device)
    m = {}
    for _ in range(steps):
        state, m = trainer.step(state, xt, yt)
    return state.params, float(m["loss"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="the card unless this names the CPU")
    ns = ap.parse_args(argv)
    if ns.steps < 1:
        ap.error("--steps must be >= 1")

    topo = mpit_tpu_torch.init(num_workers=1, device=ns.device)
    dev = topo.device
    model = TransformerLM(V, num_layers=2, d_model=32, num_heads=4, max_len=T,
                          compute_dtype=torch.float32, device=dev)
    stream = np.arange(8 * T * 2, dtype=np.int64) % V
    x = stream.reshape(-1, T)[:8]
    y = np.roll(x, -1, axis=1)
    params, loss = _train(model, 1, x, y, ns.steps, topo)
    print(f"trained {ns.steps} steps, final loss {loss:.4f}")

    prompt = list(range(8))
    print("prompt:", prompt, "(the stream continues 8, 9, 10, ... mod 17)")
    print("generate       :", generate(model, params, prompt, 8, device=dev))
    greedy = generate_fast(model, params, prompt, 8, device=dev)
    print("generate_fast  :", greedy)
    print("sampled t=0.7  :", generate_fast(
        model, params, prompt, 8, temperature=0.7, top_k=4, seed=0, device=dev))
    outs = generate_batch(model, params, [prompt, [3, 4, 5], [11, 12]], 6,
                          device=dev)
    for row in outs:
        print("batched row    :", row)
    seq, score = beam_search(model, params, prompt, 8, beam_size=4, device=dev)
    print(f"beam (K=4)     : {seq}   logprob {score:.3f}")

    # speculative: a half-size draft trained on the same stream proposes;
    # the output is the generate_fast greedy decode exactly
    draft = TransformerLM(V, num_layers=1, d_model=16, num_heads=2, max_len=T,
                          compute_dtype=torch.float32, device=dev)
    d_params, _ = _train(draft, 2, x, y, ns.steps, topo)
    spec, stats = generate_speculative(
        model, params, draft, d_params, prompt, 8, k=4, return_stats=True,
        device=dev,
    )
    print(f"speculative    : {spec}   "
          f"({stats['mean_emitted']:.1f} tokens/verify-chunk)")
    assert spec == greedy  # the exactness contract, live

    # continuous batching: three requests, one resident-cache server
    srv = Server(model, params, max_batch=2, segment=4, device=dev)
    rids = [srv.submit(q, 6) for q in (prompt, [3, 4, 5], [11, 12])]
    served = srv.drain()
    for rid in rids:
        print("served         :", served[rid])
    assert [served[r] for r in rids] == outs  # batch row n == served n (greedy)
    mpit_tpu_torch.finalize()


if __name__ == "__main__":
    main()
