"""The port's launcher refuses the LM engine's flags on the paths that do
not serve through the LM engine.

``--arch xlmr-paper`` serves through ``serve_encoder`` and ``--arch
whisper-medium`` through ``serve_encdec``; neither reads the flags of
``LM_ONLY_FLAGS``. Each of them, given a value other than its default,
must end the launcher with a ``SystemExit`` that names it, before any
model is built (``init_params`` is made to fail here, so a case that got
that far would show it)."""
import pytest

from repro_torch.launch import serve
from repro_torch.models import model as model_mod

# a value other than the default for each flag of ``LM_ONLY_FLAGS``
GIVEN = {"--precision": ["w8a8"], "--verify-quant": [],
         "--replicas": ["2"], "--replica-precisions": ["fp32,w8a8"],
         "--prefill-chunk": ["16"], "--prefix-cache": ["16"],
         "--policy": ["edf"]}
PATHS = {"xlmr-paper": "serve_encoder", "whisper-medium": "serve_encdec"}


def test_every_lm_flag_has_a_case():
    assert tuple(GIVEN) == serve.LM_ONLY_FLAGS


@pytest.mark.parametrize("flag", list(GIVEN))
@pytest.mark.parametrize("arch", list(PATHS))
def test_non_lm_path_refuses_lm_flag(monkeypatch, arch, flag):
    def built(*a, **k):
        raise AssertionError("a model was built before the flags were "
                             "checked")

    monkeypatch.setattr(model_mod, "init_params", built)
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", arch, "--device", "cpu", "--smoke", flag,
                    *GIVEN[flag]])
    msg = str(e.value)
    assert flag in msg and PATHS[arch] in msg, msg
