"""Import guard of the PyTorch/CUDA port.

An AST scan of every module under presto_tpu_torch/ and of
chip_smoke.py: nothing imports or names jax or the presto_tpu package
(presto_tpu_torch itself excepted), and no `try`/`except` surrounds a
kernel launch, so a failed launch can never fall back to another path.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "presto_tpu_torch")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        out.extend(os.path.join(root, f) for f in files if f.endswith(".py"))
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "presto_tpu"


def _launch_names():
    from presto_tpu_torch.ops import kernels
    return {n for n in kernels.__all__ if callable(getattr(kernels, n))
            and not n.endswith("_reference")} | {"limb_partial_sums_i16",
                                                 "limb_partial_sums_f32",
                                                 "fused_limb_sums",
                                                 "fused_limb_sums_batched",
                                                 "_launch_fused",
                                                 "contains_bytes_u8"}


def _called_names(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            f = sub.func
            if isinstance(f, ast.Name):
                yield f.id
            elif isinstance(f, ast.Attribute):
                yield f.attr


def test_sources_found():
    names = {os.path.relpath(p, REPO) for p in _sources()}
    assert "chip_smoke.py" in names
    for module in ("ops/kernels.py", "ops/join.py", "ops/sort.py",
                   "ops/aggregation.py", "plan/stats.py", "plan/nodes.py",
                   "expr/compile.py", "expr/functions.py",
                   "connectors/tpch/generator.py", "exec/planner.py",
                   "exec/runner.py", "parallel/mesh.py",
                   "parallel/exchange.py", "parallel/stages.py",
                   "plan/distribute.py", "plan/fragment.py", "verifier.py",
                   "serde/pages.py", "failpoints/__init__.py",
                   "failpoints/sites.py", "server/buffers.py",
                   "server/worker.py", "server/client.py",
                   "server/http_exchange.py", "server/discovery.py",
                   "server/coordinator.py", "server/protocol.py",
                   "server/protocol_structs.py", "utils/backoff.py",
                   "server/auth.py", "server/tls.py", "serde/thrift.py",
                   "server/resource_manager.py", "server/router.py",
                   "server/catalog_server.py", "native/kernels.py",
                   # the observability ledgers
                   "utils/log.py", "server/tracing.py", "exec/datapath.py",
                   "exec/timeline.py", "exec/accuracy.py", "exec/stats.py",
                   "exec/progress.py", "exec/profiler.py",
                   "exec/plan_cache.py", "exec/perfgate.py",
                   "server/flight_recorder.py", "server/history.py",
                   "server/metrics.py", "server/watchdog.py",
                   "plan/explain.py", "traceview.py",
                   # concurrent-query batching and pipeline regions
                   "exec/batching.py", "exec/regions.py"):
        assert os.path.join("presto_tpu_torch", *module.split("/")) in names


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_and_no_reference_package(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                assert not _forbidden(alias.name), (path, alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                assert not _forbidden(node.module), (path, node.module)
        elif isinstance(node, ast.Name):
            assert node.id not in ("jax", "jnp", "presto_tpu"), \
                (path, node.id, node.lineno)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "__import__":
            pytest.fail(f"{path}:{node.lineno} uses __import__")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_exception_handler_around_a_kernel_launch(path):
    launches = _launch_names()
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and node.handlers:
            called = set()
            for stmt in node.body:
                called.update(_called_names(stmt))
            assert not called & launches, \
                (path, node.lineno, sorted(called & launches))
