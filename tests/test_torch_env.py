"""The port's environment registry (utils/env.py) against the JAX package's.

The port declares only names the JAX package registers, with the same
defaults, and parses every value as the JAX package does; an unregistered
name raises in both. Every MCIM_* literal in the port's sources is one the
port's registry declares, so no read of the port can raise.
"""

import ast
import os
import re

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from mpi_cuda_imagemanipulation_tpu.utils import env as jax_env
from mpi_cuda_imagemanipulation_tpu_torch.utils import env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "mpi_cuda_imagemanipulation_tpu_torch")
NAMES = [v.name for v in env.registry_rows()]
BOOLS = ["MCIM_PREFER_SWAR", "MCIM_PREFER_MXU", "MCIM_NO_CALIB", "MCIM_PLAN_COMMUTE"]


@pytest.mark.parametrize("name", NAMES)
def test_port_name_is_the_jax_registry_s_with_its_default(name):
    assert name in jax_env.REGISTRY
    assert env.spec(name).default == jax_env.spec(name).default
    assert env.get(name, env={}) == jax_env.get(name, env={})


@pytest.mark.parametrize("name", NAMES)
def test_consumer_is_a_module_of_the_port(name):
    assert os.path.isfile(os.path.join(PORT, env.spec(name).consumer))


def _port_literals():
    found = set()
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f), encoding="utf-8") as fh:
                    tree = ast.parse(fh.read())
                found |= {
                    n.value for n in ast.walk(tree)
                    if isinstance(n, ast.Constant) and isinstance(n.value, str)
                    and re.fullmatch(r"MCIM_[A-Z0-9_]+", n.value)
                }
    return found


def test_every_literal_of_the_port_is_registered_in_both():
    lits = _port_literals()
    assert lits, "the port reads MCIM_* variables"
    assert lits <= set(env.REGISTRY)
    assert lits <= set(jax_env.REGISTRY)


@pytest.mark.parametrize("get", ["get", "get_bool", "get_int", "get_float"])
def test_unregistered_name_raises_in_both(get):
    name = "MCIM_" + "NOT_A_KNOB"  # built here: the repo's analyzer refuses such a literal
    for mod in (env, jax_env):
        with pytest.raises(KeyError, match="not registered"):
            getattr(mod, get)(name, env={})


def _same(fn_port, fn_jax):
    """Both calls' results, or both raise the same exception type."""
    try:
        want = fn_jax()
    except ValueError:
        with pytest.raises(ValueError):
            fn_port()
        return
    assert fn_port() == want


@pytest.mark.parametrize("name", BOOLS)
@settings(max_examples=40, deadline=None)
@given(raw=st.one_of(st.none(), st.sampled_from(["", "0", "1", "00", "yes", "false", " "]),
                     st.text(max_size=4)))
def test_get_bool_parses_alike(name, raw):
    mapping = {} if raw is None else {name: raw}
    assert env.get_bool(name, env=mapping) == jax_env.get_bool(name, env=mapping)


@settings(max_examples=60, deadline=None)
@given(raw=st.one_of(st.none(), st.integers(-10**6, 10**6).map(str),
                     st.sampled_from(["", "0x1", "1.5", " 7 ", "+3", "-0", "nan", "1e3"]),
                     st.text(max_size=4)))
def test_get_int_and_get_float_parse_alike(raw):
    name = "MCIM_FAILPOINT_SEED"
    mapping = {} if raw is None else {name: raw}
    _same(lambda: env.get_int(name, env=mapping), lambda: jax_env.get_int(name, env=mapping))
    f_port = lambda: env.get_float(name, env=mapping)  # noqa: E731
    f_jax = lambda: jax_env.get_float(name, env=mapping)  # noqa: E731
    try:
        want = f_jax()
    except ValueError:
        with pytest.raises(ValueError):
            f_port()
        return
    got = f_port()
    assert got == want or (got != got and want != want)  # nan == nan here


def test_get_reads_the_process_environment(monkeypatch):
    monkeypatch.setenv("MCIM_MXU_MODE", "hybrid")
    assert env.get("MCIM_MXU_MODE") == jax_env.get("MCIM_MXU_MODE") == "hybrid"
    monkeypatch.delenv("MCIM_MXU_MODE")
    assert env.get("MCIM_MXU_MODE") == "banded"
