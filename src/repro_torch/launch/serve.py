"""Serving launcher of the port: the continuous-batching engine behind a CLI.

``python -m repro_torch.launch.serve --arch gpt2-xl --tokens 32``

The CLI of ``repro/launch/serve.py`` without ``--mesh`` (the port has no
serving mesh yet) and with ``--device``: the run is on the card unless
``--device cpu`` is given, where the plain PyTorch versions of the kernels
run. Weights are random, from ``--seed``. ``--ckpt-dir`` hot-swaps the
parameters from the newest complete checkpoint there between engine steps
(``serve/handoff.py``): a Trainer's (group 0's replica) or a plain
``params`` tree. Architectures with recurrent blocks (RecurrentGemma-9B,
xLSTM-1.3B) or MLA attention (DeepSeek-V2-236B) serve through the dense
path (``path=dense``: one static batch in lockstep); ``--ckpt-dir`` and
``--int8-kv``, which only the paged path has, raise there rather than
being ignored. Kimi-K2 (MoE with GQA attention) and Chameleon-34B serve
through the paged path. The full MoE models and Chameleon-34B do not fit
one card; ``--reduced`` runs their reduced configs. Whisper-large-v3 (an
encoder-decoder) serves through the dense path at full depth: its encoder
reads ``(batch, encoder_seq_len, d_model)`` fp32 frame embeddings drawn
from the prompts' generator after the prompts (the stubbed audio
frontend, as the reference's launcher draws them), on the run's device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import registry as R
from repro_torch.serve import CheckpointPoller, PagedCacheConfig, generate, paged_supported


def main(argv=None):
    ap = argparse.ArgumentParser(description="Pier serving launcher (PyTorch)")
    ap.add_argument("--arch", default="gpt2-xl")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--sample", action="store_true",
                    help="temperature sampling instead of greedy decode")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV-pool block size")
    ap.add_argument("--int8-kv", action="store_true",
                    help="int8-quantized KV blocks")
    ap.add_argument("--ckpt-dir", default="",
                    help="hot-swap params from new complete checkpoints here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mc = (get_reduced_config(args.arch) if args.reduced
          else get_config(args.arch))
    paged, why = paged_supported(mc)
    if not paged and (args.ckpt_dir or args.int8_kv):
        raise ValueError(f"{mc.name} serves through the dense path ({why}): --ckpt-dir and "
                         f"--int8-kv are options of the paged path")

    # independent streams for the weights and the prompts
    params = R.init_params(mc, seed=args.seed, device=device)
    gen = torch.Generator().manual_seed(args.seed + 1)
    prompts = torch.randint(0, mc.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, dtype=torch.int32).numpy()
    frames = None
    if mc.is_encoder_decoder:  # made on the device, from a seed the prompts' stream gives
        frame_seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        frames = torch.randn((args.batch, mc.encoder_seq_len, mc.d_model),
                             generator=torch.Generator(device).manual_seed(frame_seed),
                             dtype=torch.float32, device=device)

    pcfg = None
    if paged:
        bs = args.block_size
        padded = -(-args.prompt_len // bs) * bs
        need = -(-(padded + args.tokens) // bs)  # blocks per sequence
        pcfg = PagedCacheConfig(num_blocks=need * args.batch + 1, block_size=bs,
                                quantized=args.int8_kv)

    poller = CheckpointPoller(args.ckpt_dir, params) if args.ckpt_dir else None
    t0 = time.perf_counter()
    out, info = generate(params, mc, prompts, args.tokens,
                         greedy=not args.sample, temperature=args.temperature,
                         seed=args.seed, pcfg=pcfg, frames=frames,
                         on_step=None if poller is None else poller.on_step)
    dt = time.perf_counter() - t0

    print(f"arch={mc.name} path={info['path']} device={device} "
          f"tokens/s={out.size / max(dt, 1e-9):.1f} ({dt:.2f}s total)")
    if paged:
        eng = info["engine"]
        print(f"engine: {eng.stats['decode_steps']} decode steps, "
              f"{eng.stats['prefills']} prefills, peak pool "
              f"{eng.stats['peak_blocks']}/{pcfg.num_blocks - 1} blocks")
    else:
        enc = (f" over {mc.encoder_seq_len} frames" if mc.is_encoder_decoder else "")
        print(f"dense: one prefill of {args.batch} x {args.prompt_len} tokens{enc}, "
              f"{args.tokens - 1} decode steps")
    print("generated[0,:16]:", np.asarray(out[0, :16]).tolist())
    if poller is not None:
        info["poller"] = poller
        if poller.swapped_steps:
            print(f"hot-swapped params at checkpoint steps {poller.swapped_steps}")
    return out, info


if __name__ == "__main__":
    main()
