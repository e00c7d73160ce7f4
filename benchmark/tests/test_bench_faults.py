"""The check fails what it must: the control (the reference put in the
program's place in bfloat16) and each fault a cell of this benchmark can
have, planted under the timed path of a whole run on the CPU (the look
for a card skipped). A one-card cell has no exchange between chips and
no mean over a batch."""

import dataclasses

import pytest
import torch

from benchmark.program import Program
from benchmark.reference.step import Reference
from benchmark.tests import bench_tiny


class Faulty(Program):
    """The program with one fault in what its step returns."""

    def __init__(self, fault):
        super().__init__("cpu")
        self.fault = fault

    def step(self, state, step_kw, **hooks):
        new, events = super().step(state, step_kw, **hooks)
        if self.fault == "unchanged":          # the step returns its state
            return state, events
        if self.fault == "half_batch":         # the second half of the worlds left out
            keep = torch.arange(state.n_worlds) < state.n_worlds // 2
            return self.state.where_worlds(keep, new, state), events
        if self.fault == "altered":            # one answer altered where it is made
            c = new.bodies.c.clone()
            c[0, 1, 0] += 0.01
            return dataclasses.replace(new, bodies=dataclasses.replace(new.bodies, c=c)), events
        raise ValueError(self.fault)


def test_sound_run_is_correct():
    assert bench_tiny.run()["correct"] is True


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_fault_is_not_correct(fault):
    r = bench_tiny.run(timed=Faulty(fault))
    assert r["correct"] is False
    assert any(isinstance(c["value"], str) or c["value"] > c["limit"]
               for c in r["compared"].values())


def test_control_in_bfloat16_is_not_correct():
    r = bench_tiny.run(timed=Reference("cpu", bf16=True))
    assert r["correct"] is False
    over = [k for k, c in r["compared"].items() if not isinstance(c["value"], str)
            and c["value"] > c["limit"]]
    assert "start_gap" in over and "position_gap_m" in over
