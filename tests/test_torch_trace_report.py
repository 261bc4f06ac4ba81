"""``trace_report``: the port's dispatch census of a re-sweep, the twin of
the reference's jaxpr counts (``tests/test_level_fused.py``): one lockstep
loop per topology level, deterministic counts, and the host syncs of the
host-looped form against none inside the fixed-trip body."""

import numpy as np
import pytest

from repro.sweep.jax_engine import trace_report as ref_trace_report
from repro_torch import sweep
from repro_torch.configs.paper_workflow import build_workflow, sweep_scenarios
from repro_torch.core.convert import workflow_from_arrays
from repro_torch.sweep.torch_engine import trace_report

from test_level_fused import _diamond

CPU = "cpu"


def _paper():
    plan = build_workflow(0.5).compile(device=CPU)
    return plan, plan.prepare(sweep_scenarios(np.linspace(0.1, 0.9, 4)))


def _diamond_port():
    plan = workflow_from_arrays(_diamond()).compile(device=CPU)
    return plan, plan.prepare([sweep.Scenario()])


@pytest.mark.parametrize("make", [_paper, _diamond_port],
                         ids=["paper", "diamond"])
def test_one_loop_per_level_and_deterministic(make):
    plan, pack = make()
    plan.sweep(pack, backend="torch")        # proves the cap, as a warm run
    rep = trace_report(plan, pack)
    assert rep["level_loops"] == 3 == len(plan.levels)
    assert rep["fixed_level_loops"] == 3
    assert not rep["overflow"]
    assert len(rep["iterations"]) == 3 and min(rep["iterations"]) >= 1
    assert rep["body_ops"] == sum(rep["body_ops_by_level"]) > 0
    assert rep["total_ops"] > rep["body_ops"]
    assert trace_report(plan, pack) == rep
    # host-looped: one guard read per iteration (and one overflow flag per
    # level); fixed-trip: nothing read back, every level runs the cap
    assert rep["host_syncs"] >= sum(rep["iterations"])
    assert rep["copies_to_host"] == 0              # the CPU is the host
    assert rep["fixed_body_reads"] == 0
    assert rep["fixed_host_syncs"] == 0
    assert rep["fixed_iterations"] == [rep["iter_cap"]] * 3
    # the guard (absent after a body that ends at the cap) is the only
    # difference between the two bodies
    for host, fixed in zip(rep["body_ops_by_level"],
                           rep["fixed_body_ops_by_level"]):
        assert host >= fixed


def test_paper_counts_match_the_reference_loop_count():
    plan, pack = _paper()
    from repro.configs.paper_workflow import build_workflow as ref_build
    from repro.configs.paper_workflow import sweep_scenarios as ref_scen

    ref_plan = ref_build(0.5).compile()
    ref_pack = ref_plan.prepare(ref_scen(np.linspace(0.1, 0.9, 4)))
    ref = ref_trace_report(ref_plan, ref_pack)
    rep = trace_report(plan, pack)
    assert rep["level_loops"] == ref["while_loops"] == 3


def test_iter_cap_argument_and_overflow():
    plan, pack = _paper()
    plan.sweep(pack, backend="torch")
    proven = trace_report(plan, pack)["iter_cap"]
    rep = trace_report(plan, pack, iter_cap=1)
    assert rep["iter_cap"] == 1
    assert rep["overflow"]          # the proven paper cap is 2
    assert proven >= 2
    big = trace_report(plan, pack, iter_cap=2 * proven)
    assert not big["overflow"] and big["iterations"] == trace_report(
        plan, pack)["iterations"]
    assert big["fixed_iterations"] == [2 * proven] * 3
