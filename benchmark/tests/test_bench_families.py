"""The harness finds everything of an env family by name: the family
module under ``drivers/families/``, the kernel's work reader under
``roofline/work/`` and the tests' sizes beside the driver and the family.
The readings of the four cells that came before this layout are held to
the values the harness read before it (``family_readings.json``, read at
the tests' size on the CPU with three seeds each, to the last digit): the
checked numbers of the program and of the control, the driver's counts,
and the bytes and operations of the cell's work reader for those counts;
and the shared modules name no family.  The learner is not among them:
its checked numbers come from float matmuls, whose last digits depend on
the host's torch and CPU, its driver gained only its tests' sizes, and
``test_bench_run.py`` holds it against the reference, the control and
the faults."""

import json
import re

import pytest
import torch

from benchmark import harness
from benchmark.drivers import by_family, family
from benchmark.roofline import window
from benchmark.tests.conftest import CELLS, tiny_cell

CPU = torch.device("cpu")
READINGS = harness.load_json(harness.HERE / "tests" / "family_readings.json")
#: Calls each reading drives; the episode calls are all counted.
CALLS = 3
#: A kernel name of each measured cell's trace, as the profiler gives it.
KERNEL = {"ctf-main.episode-b65536": "void ctf::(anonymous namespace)::steps_kernel<50>",
          "wildfire-main.episode-b65536":
              "void wildfire::(anonymous namespace)::philox_steps_kernel<8>",
          "wildfire-main.step-b65536": "void wildfire::(anonymous namespace)::step_kernel<8>"}
#: Modules every family shares, which may name none.
SHARED = ("drivers/episode.py", "drivers/__init__.py", "roofline/window.py", "faults.py",
          "tests/conftest.py")
FAMILIES = sorted(p.stem for p in (harness.HERE / "drivers" / "families").glob("*.py"))
CASES = [(name, seed) for name, by in READINGS["cells"].items() for seed in by]


def readings(name: str, seed: int) -> dict:
    """A cell's readings at the tests' size: ``CALLS`` calls, all traced
    where the driver counts traced calls, then its counts, the program's
    and the control's checks, and its work reader's bytes and operations
    for a trace with one kernel op a launch."""
    cell = tiny_cell(name)
    kind = cell.traffic["driver"]
    drv = harness.driver_module(kind).Driver(cell, seed, CPU)
    drv.traced = kind == "episode"
    for i in range(CALLS):
        drv.call(i)
    counts = drv.counts()
    drv.free()
    out = {"checked": drv.check(count=counts), "control": drv.check(control=True),
           "counts": counts}
    if window.reader(kind, cell.config["family"]) is not None:
        n = CALLS
        if kind == "episode":
            n *= -(-counts["steps_per_call"] // counts["chunk"])
        trace = harness.Trace([(KERNEL[name], 1000 * i, 500) for i in range(n)], [], 1.0, CALLS)
        run = harness.Run(cell, 1.0, harness.Window(CALLS, 1.0, [1.0] * CALLS), 0, drv.work,
                          trace, dict(counts, launches=n))
        out["work"] = list(window.work(run)[:2])
    return out


@pytest.mark.parametrize("name,seed", CASES)
def test_readings_are_as_before(name, seed):
    got, want = json.loads(json.dumps(readings(name, int(seed)))), READINGS["cells"][name][seed]
    assert got == want


@pytest.mark.parametrize("path", SHARED)
def test_shared_modules_name_no_family(path):
    text = (harness.HERE / path).read_text().lower()
    for name in FAMILIES + ["wf", "maze"]:
        assert not re.search(rf"(?<![a-z]){name}(?![a-z])", text), (path, name)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_module_has_its_parts(name):
    module = family(name)
    for part in ("config", "make", "wrapper", "call", "flat", "reference"):
        assert callable(getattr(module, part)), part
    assert isinstance(module.TINY, dict)


@pytest.mark.parametrize("name", CELLS)
def test_measured_cells_find_their_work_reader(name):
    """Each cell with a kernel roofline among its metrics finds a work
    reader for that kernel, and no other roofline's kernel."""
    cell = harness.find_cell(name)
    module = window.reader(cell.traffic["driver"], cell.config["family"])
    rooflines = [m["name"][:-len("_roofline")] for m in cell.per_layer
                 if m["name"].endswith("_roofline")]
    assert rooflines == ([module.KERNEL] if module else [])


def test_traffic_value_is_a_number_or_a_map():
    assert by_family(400, "anything") == 400
    assert by_family({"a": 400, "b": 500}, "b") == 500
