"""The run's check that the JAX package is not loaded compares whole
top-level module names."""

from benchmark.harness.guard import forbidden_loaded


def test_refuses_jax_and_the_jax_package():
    assert forbidden_loaded(["jax", "numpy"]) == ["jax"]
    assert forbidden_loaded(["jax.numpy", "jaxlib.xla_client"]) == ["jax", "jaxlib"]
    assert forbidden_loaded(["bigsi_tpu", "bigsi_tpu.graph.bigsi"]) == ["bigsi_tpu"]
    assert forbidden_loaded(["flax.linen"]) == ["flax"]


def test_passes_the_port_and_lookalikes():
    assert forbidden_loaded(["bigsi_tpu_torch", "bigsi_tpu_torch.graph.bigsi"]) == []
    assert forbidden_loaded(["jaxtyping", "flaxen", "torch", "benchmark.harness"]) == []


def test_the_reference_loads_nothing_of_the_program():
    import subprocess
    import sys

    from benchmark.harness.spec import ROOT

    code = ("import sys; import benchmark.reference.search, benchmark.reference.classic, "
            "benchmark.reference.minimizer, benchmark.reference.score; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'bigsi_tpu_torch', 'bigsi_tpu', 'torch', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr
