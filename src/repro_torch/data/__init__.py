from repro_torch.data.synthetic import SyntheticSpec, make_classification_data
from repro_torch.data.federated import (FederatedDataset, partition, EMNIST_LIKE,
                                        CINIC_LIKE, letter_frequency_probs,
                                        normal_pdf_probs, instagram_sizes)

__all__ = ["SyntheticSpec", "make_classification_data", "FederatedDataset",
           "partition", "EMNIST_LIKE", "CINIC_LIKE", "letter_frequency_probs",
           "normal_pdf_probs", "instagram_sizes"]
