"""The trace reduction on made-up intervals."""

from mgbench import spec, trace as tracing

PATTERNS = spec.read_data("metrics/kernel_layers.json")["patterns"]


def test_union_and_gaps():
    ops = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 22, 25)]
    assert tracing.union_ns(ops) == 25
    assert tracing.idle_gaps(ops, (0, 40)) == [(15, 20), (30, 40)]
    assert tracing.union_ns(tracing.clip(ops, (8, 24))) == 11


def test_host_at_takes_the_innermost_range():
    host = [("mgbench.run", 0, 100), ("cudaStreamSynchronize", 40, 60)]
    assert tracing.host_at(host, 50) == "cudaStreamSynchronize"
    assert tracing.host_at(host, 20) == "mgbench.run"
    assert tracing.host_at(host, 200) == "harness loop"


def test_layers_of_kernel_names():
    names = {
        "void at::native::vectorized_elementwise_kernel<4, Foo>(int)":
            "torch ops",
        "void at::native::reduce_kernel<512, 1, R>(R)": "torch ops",
        "void gemv2T_kernel_val<int, int, float>(P)": "torch ops",
        "void smooth_v_kernel<float, 1>(A)": "kernels",
        "void descend_kernel<float>(TowerArgs)": "kernels",
        "void delta_open_kernel<float>(float const*)": "kernels",
        "while_set_kernel(unsigned long long, int*)": "compiled loops",
        "Memcpy DtoD (Device -> Device)": "copies",
        "some_unknown": "other",
    }
    for name, layer in names.items():
        assert tracing.layer_of(name, PATTERNS) == layer


def test_breakdown_names_ops_by_layer_and_gaps_by_host():
    t = tracing.Trace(
        kernels=[("void smooth_v_kernel<float>(A)", 0, 4000),
                 ("void at::native::reduce_kernel<1>(R)", 5000, 6000)],
        copies=[("Memcpy DtoD (Device -> Device)", 9000, 9500)],
        host=[("mgbench.run", 0, 10000),
              ("mgbench.certificates", 6000, 9000)],
        span=(0, 10000))
    b = tracing.breakdown(t, PATTERNS)
    assert b["device_ops"][0] == ["kernels: void smooth_v_kernel(A)", 4e-6]
    assert b["idle_gaps"][0] == ["mgbench.certificates", 3e-6]
    assert tracing.layer_seconds(t, PATTERNS, "torch ops") == 1e-6
