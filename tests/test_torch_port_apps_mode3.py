"""Port parity, the eval applications: run.sh mode 3 (the new mirror,
traced to level 50) through the eval CLI, the case that
`test_torch_port_apps.py` holds for the other modes. It is a module of its
own so that `--dist loadfile` runs it on a worker of its own."""

import pytest

from test_torch_port_apps import cli_scene, guest_files  # noqa: F401
from test_torch_port_apps import eval_cli_application


@pytest.mark.parametrize("mode", ["3"])
def test_eval_cli_applications(cli_scene, guest_files, mode, monkeypatch):
    eval_cli_application(cli_scene, guest_files, mode, monkeypatch)
