from repro_torch.models.cnn import (CinicCNN, EmnistCNN, cinic_cnn, count_params,
                                   cross_entropy_loss, emnist_cnn, init_params)

__all__ = ["CinicCNN", "EmnistCNN", "cinic_cnn", "count_params",
           "cross_entropy_loss", "emnist_cnn", "init_params"]
