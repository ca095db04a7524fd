"""End-to-end serving example: prefill -> KV-cached decode through every
serving lever the port ships (the counterpart of
``examples/serve_lm.py``): ragged batching, grouped-query heads,
top-k/top-p sampling, an int8 KV cache, weight-only int8, speculative
draft-and-verify decoding, the continuous-batching engine over the
paged pool, and a shared cached prefix.

On the card (the default; prefill through the flash kernel, the engine's
decode through the paged decode kernel):

    python -m tpu_composer_torch.examples.serve_lm

A quick local check on the CPU (reference attention, the engine's
gather path):

    python -m tpu_composer_torch.examples.serve_lm --device cpu

Weights are random: the output is noise, the point is the serving
machinery end to end. The JAX example first probes a TPU relay's
endpoints so that a dead relay degrades to the CPU; an H100 has no
relay, and the port never moves to the CPU unasked: ``--device cuda``
without a card is an error.
"""

import argparse
import time

import torch

from tpu_composer_torch.device import resolve_device
from tpu_composer_torch.models.decode import generate
from tpu_composer_torch.models.quant import quantize_decode_params
from tpu_composer_torch.models.serving import ContinuousBatchingEngine
from tpu_composer_torch.models.speculative import speculative_generate
from tpu_composer_torch.models.transformer import ModelConfig, init_params


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--new-tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top-k", type=int, default=50)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--gamma", type=int, default=4,
                   help="speculative draft length")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)  # raises without a card
    on_card = device.type == "cuda"
    c = ModelConfig(
        vocab_size=2048, d_model=256, n_layers=2, n_heads=8, n_kv_heads=2,
        d_ff=704, max_seq=args.prompt_len + args.new_tokens + args.gamma + 1,
        dtype=torch.bfloat16, attn_impl="flash" if on_card else "reference",
    )
    params = init_params(c, seed=0, device=device)
    qparams = quantize_decode_params(params)  # weight-only int8 draft
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"device: {name}")

    # Ragged batch: every row its own prompt length, right-padded.
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, c.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, dtype=torch.int32).to(device)
    lens = torch.tensor([args.prompt_len - (i % 3) for i in range(args.batch)],
                        dtype=torch.int32, device=device)

    t0 = time.perf_counter()
    sampled = generate(
        params, prompts, c, max_new_tokens=args.new_tokens,
        prompt_lens=lens, kv_quant=True,  # int8 KV cache
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        seed=2,
    )
    _sync(device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.new_tokens
    print(f"sampled  : {tuple(sampled.shape)} in {dt:.2f}s "
          f"({toks / dt:.0f} tok/s) — ragged batch, int8 KV, top-k/top-p")

    t0 = time.perf_counter()
    greedy = speculative_generate(
        params, qparams, prompts[:1], c,
        max_new_tokens=args.new_tokens, gamma=args.gamma,
    )
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"spec-dec : {tuple(greedy.shape)} in {dt:.2f}s — int8 self-draft,"
          f" greedy-equivalent up to float tie-breaking")

    # Continuous batching over the paged block-pool cache: requests of
    # different lengths stream through fixed batch slots; each emits
    # exactly the tokens its solo run would.
    engine_attn = "kernel" if on_card else "gather"
    eng = ContinuousBatchingEngine(
        params, c, slots=min(2, args.batch),
        num_blocks=4 * (args.prompt_len + args.new_tokens) // 8 + 8,
        block_size=8, kv_quant=True, attn_impl=engine_attn,
    )
    t0 = time.perf_counter()
    reqs = [eng.submit(prompts[i, :int(lens[i])].tolist(), args.new_tokens)
            for i in range(min(3, args.batch))]
    eng.run()
    dt = time.perf_counter() - t0
    done = sum(len(r.tokens) for r in reqs)
    print(f"engine   : {len(reqs)} requests / {done} tokens in {dt:.2f}s "
          f"— continuous batching, paged int8 pool")

    # Shared-prefix caching: a "system prompt" prefilled once, attached by
    # reference; each request still equals its solo run.
    room = c.max_seq - 8 - 1  # budget after an 8-token prefix + suffix
    if room < 1:
        print("prefix   : skipped (max_seq too small for the 8-token "
              "system prompt at these sizes)")
        return
    eng2 = ContinuousBatchingEngine(
        params, c, slots=2,
        num_blocks=4 * (args.prompt_len + args.new_tokens) // 8 + 16,
        block_size=8, prefill_chunk=8, attn_impl=engine_attn)
    sys_prompt = list(range(1, 9))  # block-aligned
    h = eng2.register_prefix(sys_prompt)
    gen_n = min(args.new_tokens, room)
    t0 = time.perf_counter()
    shared = [eng2.submit(sys_prompt + [i + 1], gen_n, prefix=h)
              for i in range(min(3, args.batch))]
    eng2.run()
    eng2.close_prefix(h)
    dt = time.perf_counter() - t0
    done = sum(len(r.tokens) for r in shared)
    print(f"prefix   : {len(shared)} requests sharing one cached "
          f"system prompt / {done} tokens in {dt:.2f}s")


if __name__ == "__main__":
    main()
