"""Quickstart: deploy a model through EASEY in a dozen lines (port of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Writes an Appfile (the paper's Dockerfile analogue), builds it for the
device's own target (``nvidia:h100`` on the card, with its hand-written
kernels; ``local:cpu`` with ``--device cpu``), packages it, submits it
through the middleware (Algorithm 1) and polls status + logs — the full
Fig. 2 workflow.  Without a GPU it raises unless given ``--device cpu``.
"""

import argparse
import tempfile

from repro_torch.core.appspec import parse_appfile
from repro_torch.core.jobspec import parse_jobspec
from repro_torch.core.target import default_target, resolve_device
from repro_torch.core.workflow import run_easey

APPFILE = """\
FROM arch:deepseek-7b-smoke
SHAPE train_4k
###include_local_kernels###
###include_local_collectives###
SET vocab_size=256
RUN train --steps 10
"""

JOBCONFIG = {
    "job": {"name": "quickstart", "mail": "you@example.org"},
    "deployment": {"nodes": 1, "tasks-per-node": 1, "clocktime": "00:10:00"},
    "execution": [{"serial": {
        "command": "train --steps 10 --seq-len 64 --global-batch 4 "
                   "--arch deepseek-7b-smoke"}}],
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain versions of the kernels on the CPU)")
    a = p.parse_args(argv)
    target = default_target(resolve_device(a.device))

    app = parse_appfile(APPFILE)
    app.shape_overrides = {"seq_len": 64, "global_batch": 4}
    spec = parse_jobspec(JOBCONFIG)

    mw, job_id, build = run_easey(app, target, spec,
                                  storage=tempfile.mkdtemp(prefix="easey_"))
    print(f"jobID={job_id} state={mw.status(job_id).value}")
    print("--- tuning report -------------------------------------------")
    print(build.plan.report())
    print("--- job stdout ----------------------------------------------")
    out, err = mw.logs(job_id)
    print(out)
    if err:
        print("STDERR:", err)
    return mw, job_id, build


if __name__ == "__main__":
    main()
