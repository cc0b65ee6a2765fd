"""What every kind of cell shares: the inputs from the seed, the port's
preparation of them, the model with the benchmark's weights, and the
closed window.

A kind (``kinds/<kind>.py``) subclasses :class:`Cell` and supplies
``start_check`` (after ``prepare`` and ``build``: its feed and, where the
check needs them, the program's first outputs), ``start_window`` (the
rest of set-up: the warm-up), ``call(i)`` (one unit of window work;
returns the work it did, in the cell's unit), ``trace_work`` (a fixed
piece of work for the traced window), ``end_to_end``, ``outputs`` (the
program's outputs that the check judges), ``reference`` (the plain
reference's readings, run once the program's state is freed), ``compare``
(the check's numbers) and ``layer_readings``.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Sequence

import torch

from h100_bench import inputs, manifest, port


class Cell:
    """One run of one cell on ``device``, its inputs drawn from ``seed``;
    ``extra_flags`` are added to the configuration's CLI flags."""

    def __init__(self, spec: Dict, seed: int, device, extra_flags: Sequence[str] = ()):
        self.cfg = spec["config"]
        self.model_cfg = self.cfg["model"]
        self.traffic = spec["traffic"]
        self.limits = spec["limits"].get("limits", {})
        self.seed = int(seed)
        self.device = torch.device(device)
        self.ref = manifest.reference(self.cfg["reference"])
        self.args = port.args(self.model_cfg, extra_flags)
        self.readings: Dict = {"setup": {}, "window": {}, "trace": None}
        self.model = None

    # -- set-up -------------------------------------------------------------

    def make_inputs(self) -> Dict:
        return inputs.make(self.cfg["dataset"], self.seed, self.device)

    def prepare(self) -> None:
        """The inputs, and the port's surgery and graph build on them."""
        t0 = time.perf_counter()
        raw = self.make_inputs()
        self.num_nodes = raw["num_nodes"]
        self.node_feats = raw["node_feat"]
        self.num_feats = 0 if self.node_feats is None else self.node_feats.shape[1]
        ds = inputs.to_numpy(raw, bool(self.cfg["dataset"].get("directed")))
        self.readings["setup"]["inputs_s"] = time.perf_counter() - t0
        self.raw_train = raw["split_edge"]["train"]
        del raw
        self.prog = port.prepare(ds, self.args, self.device)
        self.readings["setup"]["prepare_s"] = self.prog["prepare_s"]

    def initial_weights(self) -> Dict:
        shapes = self.ref.param_shapes(self.model_cfg, self.num_nodes, self.num_feats)
        return inputs.weights(shapes, self.seed, self.device)

    def build(self, args=None) -> None:
        """The port's model and optimizer with the benchmark's weights."""
        t0 = time.perf_counter()
        weights = self.initial_weights()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.readings["setup"]["weights_s"] = time.perf_counter() - t0
        self.model, self.opt = port.build_model(
            args or self.args, self.num_nodes, self.num_feats, weights, self.device
        )

    def setup(self) -> None:
        """Set-up in its phases, each timed on the host clock after a sync."""
        for phase in (self.prepare, self.build, self.start_check, self.start_window):
            t0 = time.perf_counter()
            phase()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.readings["setup"][phase.__name__ + "_s"] = time.perf_counter() - t0

    def start_check(self) -> None:
        raise NotImplementedError

    def start_window(self) -> None:
        raise NotImplementedError

    # -- the window ---------------------------------------------------------

    def call(self, i: int) -> float:
        raise NotImplementedError

    def window(self, seconds: float) -> Dict:
        """Calls until ``seconds`` have passed; the last call is finished
        and counted, so the rate spans all the work and all the time."""
        t0 = time.perf_counter()
        work, calls = 0.0, 0
        while True:
            work += self.call(calls)
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.readings["window"].update(seconds=elapsed, work=work, calls=calls)
        return self.readings["window"]

    def trace_work(self) -> None:
        raise NotImplementedError

    def control_work(self, seconds: float) -> None:
        """What ``control.py`` runs after ``start_check`` for the outputs
        the check judges (nothing where ``start_check`` made them)."""

    def end_to_end(self) -> Dict:
        """The window's end-to-end numbers by metric name."""
        raise NotImplementedError

    # -- the check ----------------------------------------------------------

    def free_program(self) -> None:
        """Drop the program's state before the reference runs."""
        for name in ("model", "opt", "prog", "scorer", "eval_pairs", "pos", "pos_w", "feed"):
            if hasattr(self, name):
                setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_inputs(self):
        """The inputs again, the reference's adjacency and positives, and the
        weights: all worked out from the seed, nothing taken from the port."""
        raw = self.make_inputs()
        adj, pos = self.ref.derive(self.model_cfg, raw)
        shapes = self.ref.param_shapes(self.model_cfg, self.num_nodes, self.num_feats)
        weights = inputs.weights(shapes, self.seed, self.device)
        self.shape = self.ref.model_shape(self.model_cfg, adj, self.num_feats)
        return raw, adj, pos, weights

    def outputs(self):
        raise NotImplementedError

    def reference(self):
        raise NotImplementedError

    def compare(self, outputs, reference) -> Dict:
        raise NotImplementedError

    def check(self) -> List[Dict]:
        """The program's outputs judged against the reference, which runs
        once the program's state is freed."""
        outputs = self.outputs()
        self.free_program()
        return self.judged(self.compare(outputs, self.reference()))

    def judged(self, values: Dict) -> List[Dict]:
        """The numbers the cell's limits name, each beside its limit (a
        named number the comparison does not give reads as infinite)."""
        return [
            {"name": k, "value": float(values.get(k, float("inf"))), "limit": float(limit)}
            for k, limit in self.limits.items()
        ]

    def layer_readings(self) -> Dict:
        return self.readings
