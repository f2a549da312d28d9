"""The online recognizer (see isbfsar_tpu_torch/__init__.py)."""

from isbfsar_tpu_torch.ar.recognizer import ActionRecognizer  # noqa: F401
