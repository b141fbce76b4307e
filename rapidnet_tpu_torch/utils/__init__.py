from rapidnet_tpu_torch.utils.timing import TicToc

__all__ = ["TicToc"]
