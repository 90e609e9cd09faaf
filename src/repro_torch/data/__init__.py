from repro_torch.data.synthetic import (batch_for, embeds_batch, lm_batch,
                                        mnist_like)

__all__ = ["batch_for", "embeds_batch", "lm_batch", "mnist_like"]
