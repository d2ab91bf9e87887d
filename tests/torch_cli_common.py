"""Fixtures shared by the command-line tests (``tests/test_torch_cli.py``
and ``tests/test_torch_cli_grounding.py``); a test module imports them by
name."""

import sys

import pytest


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # set_path writes log<prefix>/ under the cwd
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the JSONL log
    return tmp_path
