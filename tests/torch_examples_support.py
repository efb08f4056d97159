"""What the tests of the ported examples share: the loaders of an
``examples_torch/`` module and of a run of its ``examples/`` counterpart,
and their fixtures (imported by ``test_torch_examples.py`` and
``test_torch_examples_pmc.py``)."""

import importlib.util
import os
import runpy
import sys

import pytest

import pypmc_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless the CPU is asked for: ask for it."""
    with pypmc_tpu_torch.using_device("cpu"):
        yield


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """Run in ``tmp_path`` (the examples write their plots to the working
    directory) with matplotlib's Agg backend."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MPLBACKEND", "Agg")
    return tmp_path


def port_example(name):
    """``examples_torch/<name>.py`` as a module."""
    path = os.path.join(REPO, "examples_torch", name + ".py")
    spec = importlib.util.spec_from_file_location("examples_torch_" + name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_example(name, monkeypatch):
    """Run ``examples/<name>.py`` as a script; returns its globals."""
    path = os.path.join(REPO, "examples", name + ".py")
    monkeypatch.setattr(sys, "argv", [path])
    return runpy.run_path(path, run_name="__main__")
