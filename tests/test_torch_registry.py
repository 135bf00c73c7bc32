"""Every model the JAX package registers has a registration in the port."""
import video_tokenizer_tpu.models  # noqa: F401
from video_tokenizer_tpu.registry import models as jmodels
import video_tokenizer_tpu_torch.models  # noqa: F401
from video_tokenizer_tpu_torch.registry import models as tmodels


def test_every_jax_model_name_is_registered_in_the_port():
    missing = sorted(set(jmodels.keys()) - set(tmodels.keys()))
    assert not missing, f"the port registers none of {missing}"
    assert len(list(jmodels.keys())) == 59
