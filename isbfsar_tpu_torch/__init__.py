"""PyTorch/CUDA port of isbfsar_tpu: I420 frame -> pose -> TRX match.

Imports torch and numpy only; nothing of JAX and nothing of the JAX
package. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
