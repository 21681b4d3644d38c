"""Astraea on the transformer stack: federated LM training (the port's
twin of the JAX package's ``examples/federated_llm.py``, whose fixed
settings -- 3 rounds, 8 clients, gamma 4, seq 128 -- are
``launch.fl_train``'s defaults, so it is that launcher).

  PYTHONPATH=src python -m repro_torch.examples.federated_llm --arch hymba-1.5b --device cpu
  PYTHONPATH=src python -m repro_torch.examples.federated_llm --lora-rank 4
"""
from repro_torch.launch.fl_train import main

if __name__ == "__main__":
    main()
