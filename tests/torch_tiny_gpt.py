"""The tiny GPT both packages' generation tests share: the JAX startup
program's parameters (its threefry init cannot be reproduced in torch)
in a JAX ``GPTGenerator`` and, through ``params_from_jax``, in the port's
on the CPU, with seeded prompts."""
import numpy as np

import paddle_tpu as fluid
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models.generation import GPTGenerator as JGenerator
from paddle_tpu_torch.models import GPTConfig, GPTGenerator

MAX_LEN, BUCKET_MIN = 48, 8


def tiny_pair():
    """``(port generator, JAX generator, JAX scope)`` of GPTConfig.tiny()."""
    jcfg = jgpt.GPTConfig.tiny()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        jgpt.gpt_logits(jcfg)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor().run(startup)
    arrays = {n: np.asarray(v) for n, v in scope.items()
              if not n.startswith("@")}
    jgen = JGenerator(jcfg, scope, max_len=MAX_LEN, bucket_min=BUCKET_MIN)
    tgen = GPTGenerator(GPTConfig.tiny(), arrays, max_len=MAX_LEN,
                        bucket_min=BUCKET_MIN, device="cpu")
    return tgen, jgen, scope


def prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


def repetitive_prompt(n=12):
    return np.array(([5, 6, 7] * ((n + 2) // 3))[:n], np.int32)


def run_bank(engine, reqs, spec_k=0, stats=None, drafter=None):
    """Drive ``reqs`` (GenerationRequests of either package) through a
    DecodeBatcher of the engine's package; returns the token lists."""
    mod = type(engine).__module__.split(".")[0]
    batching = __import__(f"{mod}.serving.batching", fromlist=["x"])
    b = batching.DecodeBatcher(batching.RequestQueue(max_depth=64), engine,
                               stats=stats, spec_k=spec_k,
                               drafter=drafter).start()
    try:
        for r in reqs:
            b.queue.put(r)
        return [r.wait(timeout=120)[0].tolist() for r in reqs]
    finally:
        b.stop()
