"""The reference's own ledger tests, run against the port.

`reference_cases(file, names)` reads tests/<file> (a test module of the
reference), renames the package `presto_tpu` to `presto_tpu_torch` in
its source and runs it as a module of its own, then returns the named
test functions (and the module's fixtures) for a port test file to put
into its namespace: the reference's cases, unchanged, over the port's
modules. The reference runs on the CPU when no device is named, the
port on CUDA: `cpu_by_default`, which comes with the cases, makes a
device left unnamed the CPU for the test module, as a caller that asks
for the CPU would. A port test file names the cases it leaves out and
why, and writes those in the port's terms where they apply.
"""

import os
import re
import types

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
SF = 0.01

_MODULES = {}


def _module(file: str) -> types.ModuleType:
    mod = _MODULES.get(file)
    if mod is None:
        path = os.path.join(TESTS, file)
        with open(path, encoding="utf-8") as f:
            src = re.sub(r"\bpresto_tpu\b", "presto_tpu_torch", f.read())
        mod = types.ModuleType(f"_port_of_{file[:-3]}")
        mod.__file__ = path
        exec(compile(src, path, "exec"), mod.__dict__)
        _MODULES[file] = mod
    return mod


def reference_cases(file: str, names) -> dict:
    """{name: object} of the named tests of tests/<file>, run over the
    port, and of every fixture that module defines."""
    mod = _module(file)
    out = {n: getattr(mod, n) for n in names}
    out["cpu_by_default"] = cpu_by_default
    for k, v in vars(mod).items():
        if hasattr(v, "_pytestfixturefunction") or \
                type(v).__name__ == "FixtureFunctionDefinition":
            out.setdefault(k, v)
    return out


def all_test_names(file: str):
    return sorted(k for k in vars(_module(file)) if k.startswith("test_"))


def port_sql(text: str, sf: float = SF, **kw):
    """The port's sql() on the CPU."""
    from presto_tpu_torch import sql
    return sql(text, sf=sf, device="cpu", **kw)


@pytest.fixture
def fresh_ledgers():
    """Empty process registries of every ledger, before and after."""
    from presto_tpu_torch.exec import accuracy, datapath, profiler, timeline
    from presto_tpu_torch.exec.progress import reset
    for clear in (datapath.clear_datapath, accuracy.clear_accuracy,
                  timeline.clear_timeline, profiler.clear_profiler, reset):
        clear()
    yield
    for clear in (datapath.clear_datapath, accuracy.clear_accuracy,
                  timeline.clear_timeline, profiler.clear_profiler, reset):
        clear()


@pytest.fixture(autouse=True, scope="module")
def cpu_by_default():
    """The reference's cases name no device (the reference runs on the
    CPU by default); here the caller that names none asks for the CPU:
    every entry point of the port resolves `device=None` to the CPU for
    the test module's duration (module-scoped, so that the module's own
    fixtures, servers among them, see it too)."""
    import torch

    import presto_tpu_torch.block as block
    import presto_tpu_torch.exec.runner as runner
    import presto_tpu_torch.server.statement as statement
    import presto_tpu_torch.server.worker as worker
    real = block.resolve_device

    def resolve(device=None):
        return torch.device("cpu") if device is None else real(device)

    mods = (block, runner, statement, worker)
    for mod in mods:
        mod.resolve_device = resolve
    yield
    for mod in mods:
        mod.resolve_device = real
