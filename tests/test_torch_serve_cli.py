"""The port's serving CLI (``repro_torch.launch.serve.main``): the engine's
prefix-cache flags take the reference CLI's tri-state —
``--prefix-cache`` forces the cache on, ``--no-prefix-cache`` off,
neither leaves the choice to the engine, and the two together are
refused (``repro/launch/serve.py:355-362, 440-446``)."""
import pytest

from repro_torch.launch import serve as tserve
from tests.torch_threads import one_torch_thread  # noqa: F401


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flags,want", [([], None),
                                        (["--prefix-cache"], True),
                                        (["--no-prefix-cache"], False)])
def test_prefix_cache_tri_state(flags, want, monkeypatch):
    seen = {}

    def fake_engine(arch, **kw):
        seen.update(kw, arch=arch)
        raise _Stop

    monkeypatch.setattr(tserve, "serve_engine", fake_engine)
    with pytest.raises(_Stop):
        tserve.main(["--arch", "qwen3_1_7b", "--engine", "--device", "cpu",
                     *flags])
    assert seen["arch"] == "qwen3_1_7b"
    assert seen["prefix_cache"] is want


def test_prefix_cache_flags_clash(monkeypatch, capsys):
    monkeypatch.setattr(tserve, "serve_engine", lambda *a, **k: 1 / 0)
    with pytest.raises(SystemExit) as e:
        tserve.main(["--arch", "qwen3_1_7b", "--engine", "--prefix-cache",
                     "--no-prefix-cache"])
    assert e.value.code == 2
    assert "mutually exclusive" in capsys.readouterr().err
