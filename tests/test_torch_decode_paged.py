"""GPT's paged generation programs of the port (``gpt_decode_step_paged``,
``gpt_prefill_chunk_paged``, ``gpt_verify_step_paged``, fp32 and int8
pools) against the JAX package's builders of the same name, on the CPU
at ``GPTConfig.tiny()`` from the JAX startup's parameters: feed names
and ``cache_names`` equal, logits and float pools within 1e-5 of max
|ref|, int8 pools within one quantization step (a value on a rounding
boundary), as ``test_torch_decode_programs.py`` runs the dense ones."""
import pytest

from test_torch_decode_programs import builder_matches_jax

CASES = [(n, d) for n in ("gpt_decode_step_paged", "gpt_prefill_chunk_paged",
                          "gpt_verify_step_paged") for d in ("fp32", "int8")]


@pytest.mark.parametrize("name,kv_dtype", CASES,
                         ids=[f"{n}-{d}" for n, d in CASES])
def test_paged_builder_matches_jax(name, kv_dtype):
    builder_matches_jax(name, kv_dtype)
