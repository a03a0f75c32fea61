"""The pass and op attribution on a small synthetic trace."""

import pytest

from mvbench import trace


def ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def synthetic():
    """Two passes on the host, one op call inside the second; three
    kernels, each launched in one of them and run later; one copy
    launched between passes."""
    return {"traceEvents": [
        ev(trace.WINDOW, "user_annotation", 0, 1000),
        ev("pass:prep", "user_annotation", 10, 90),
        ev("pass:sweep", "user_annotation", 100, 300),
        ev("op:sweep_march", "user_annotation", 150, 50),
        ev("cudaLaunchKernel", "cuda_runtime", 20, 5, correlation=1),
        ev("cudaLaunchKernelExC", "cuda_runtime", 160, 5, correlation=2),
        ev("cudaLaunchKernel", "cuda_runtime", 300, 5, correlation=3),
        ev("cudaMemcpyAsync", "cuda_runtime", 500, 5, correlation=4),
        ev("void (anonymous namespace)::glue_kernel<float>(float*)",
           "kernel", 200, 100, correlation=1),
        ev("void (anonymous namespace)::sweep_kernel<bf16, true>(int)",
           "kernel", 350, 200, correlation=2),
        ev("glue_kernel<float>", "kernel", 600, 100, correlation=3),
        ev("Memcpy HtoD", "gpu_memcpy", 700, 50, correlation=4),
    ]}


def test_attribution():
    r = trace.read(synthetic(), frames=1)
    assert r["passes"]["prep"]["device_ms"] == pytest.approx(0.1)
    assert r["passes"]["sweep"]["device_ms"] == pytest.approx(0.3)
    assert r["passes"]["prep"]["host_ms"] == pytest.approx(0.09)
    assert r["passes"]["sweep"]["kernels"] == 2
    call, = r["ops"]["sweep_march"]
    assert call["kernels"] == {"sweep_kernel<bf16, true>": 200e-6}
    assert r["kernels"] == 3
    assert r["device_ops"]["glue_kernel<float>"] == pytest.approx(200e-6)


def test_busy_and_idle():
    r = trace.read(synthetic(), frames=2)
    # busy 200-300, 350-550, 600-750 of the window 0-1000
    assert r["busy_s"] == pytest.approx(450e-6)
    assert r["window_s"] == pytest.approx(1000e-6)
    # the gap 300-350 begins while the host is in pass:sweep; 0-200,
    # 550-600 and 750-1000 between passes
    assert r["idle_by_pass"] == pytest.approx(
        {"pass:sweep": 50e-6, "(between passes)": 500e-6})
    assert r["passes"]["prep"]["host_ms"] == pytest.approx(0.045)


def test_short_names():
    assert trace.short_name(
        "void (anonymous namespace)::taa_resolve_kernel<false>(float const*"
        ", int)") == "taa_resolve_kernel<false>"
