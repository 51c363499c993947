"""The port's copy of ``examples/serve_batched.py``
(``examples/serve_batched_torch.py``): at ``--batch 2 --prompt-len 8
--gen-tokens 4`` it prints the reference example's lines, numbers aside, as
a CPU process that imports neither jax nor repro; in process its result
holds the batch's generated ids. The weights are drawn by each package's
own generator, so the ids differ; token parity on carried weights is
``tests/test_torch_models.py::TestServe::test_greedy_tokens_equal_the_reference_serve``.
"""
import numpy as np
import pytest

from _example_parity import NUMBER, load_example, run_printed, run_script, template

ARGS = ("--batch", "2", "--prompt-len", "8", "--gen-tokens", "4")


@pytest.fixture(scope="module")
def reference_lines():
    return run_script("serve_batched.py", *ARGS)


def test_example_prints_the_reference_lines(reference_lines):
    lines = run_script("serve_batched_torch.py", *ARGS, "--device", "cpu")
    assert [template(x) for x in lines] == [template(x) for x in reference_lines]
    assert lines[0] == reference_lines[0] == "[serve_batched] mixtral-reduced"
    assert lines[1].startswith("  prefill (2 x 8 tokens): ")
    for line in lines[3:]:
        assert len(NUMBER.findall(line.split(":", 1)[1])) == 4


def test_main_returns_the_generated_ids():
    example = load_example("serve_batched_torch.py")
    res, lines = run_printed(example.main, ["--device", "cpu", *ARGS])
    gen = res["generated"]
    assert gen.shape == (2, 4) and gen.dtype.kind == "i"
    assert np.all((0 <= gen) & (gen < 512))
    for i, line in enumerate(lines[3:]):
        assert line == f"  request {i} continuation ids: {gen[i, :12].tolist()}"
    again, _ = run_printed(example.main, ["--device", "cpu", *ARGS])
    np.testing.assert_array_equal(again["generated"], gen)
