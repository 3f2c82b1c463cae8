"""PyTorch port: the numpy config copies equal the reference field for field."""
import dataclasses
import enum

import numpy as np
import pytest

from torch_port_ref import load_reference

from repro_torch.core import characterization as C
from repro_torch.core import scenarios as S


@pytest.fixture(scope="module")
def ref():
    return load_reference()


def _plain(x):
    """Recursively turn a config into comparable python/numpy values."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return int(x.value)
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.tolist())
    return x


def _assert_same(a, b):
    assert _plain(a) == _plain(b)


def test_characterization_matches_reference(ref):
    _assert_same(C.paper_power_table(), ref.characterization.paper_power_table())
    _assert_same(C.paper_sleep_spec(), ref.characterization.paper_sleep_spec())
    _assert_same(C.paper_machine_profile(),
                 ref.characterization.paper_machine_profile())
    t = C.paper_power_table().scaled(-2.0, 0.1)
    t_ref = ref.characterization.paper_power_table().scaled(-2.0, 0.1)
    _assert_same(t, t_ref)
    sl = C.paper_sleep_spec()
    assert sl.transition_time == 30.0 and sl.transition_energy == 1730.0
    with pytest.raises(ValueError):
        C.PowerTable(freq_ghz=[1.0, 2.0], p_comp=[1, 1], beta=[1, 1],
                     p_ckpt=[1, 1], gamma=[1, 1])


def test_paper_scenarios_match_reference(ref):
    ours, theirs = S.paper_scenarios(), ref.scenarios.paper_scenarios()
    assert list(ours) == list(theirs)
    for name in ours:
        _assert_same(ours[name], theirs[name])
        assert ours[name].t_recover == theirs[name].t_recover
    _assert_same(S.sparse_rendezvous_scenario(),
                 ref.scenarios.sparse_rendezvous_scenario())


@pytest.mark.parametrize("p_star", [None, 5000.0])
def test_post_recovery_config_matches_reference(ref, p_star):
    for name, cfg in S.paper_scenarios().items():
        _assert_same(S.post_recovery_config(cfg, p_star=p_star),
                     ref.scenarios.post_recovery_config(
                         ref.scenarios.paper_scenarios()[name], p_star=p_star))


def test_apply_policy_matches_reference(ref):
    kw = dict(ckpt_interval=2400.0, mu1=3.8, mu2=0.9, wait_mode=1,
              move_ahead_frac=0.25, move_ahead=False)
    _assert_same(S.apply_policy(S.sparse_rendezvous_scenario(), **kw),
                 ref.scenarios.apply_policy(
                     ref.scenarios.sparse_rendezvous_scenario(), **kw))
