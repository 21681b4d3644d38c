from repro_torch.models.cnn import (EmnistCNN, count_params, cross_entropy_loss,
                                   emnist_cnn, init_params)

__all__ = ["EmnistCNN", "count_params", "cross_entropy_loss", "emnist_cnn",
           "init_params"]
