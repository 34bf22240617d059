"""The paper's own FL workloads (§VI-A): small CNNs for EMNIST-Letter and
CIFAR-10, trained on synthetic class-conditional data of matching shape
(``repro_torch.data.synthetic``).  The generic ``ModelConfig`` fields carry
the widths; the networks live in ``repro_torch.models.cnn``."""
from .base import ModelConfig, register

EMNIST_CNN = register(ModelConfig(
    name="emnist-cnn", family="cnn", source="paper sec VI-A (EMNIST-Letter)",
    n_layers=2, d_model=10, d_ff=1280, vocab=26,  # conv channels / fc1 / classes
))
CIFAR_CNN = register(ModelConfig(
    name="cifar-cnn", family="cnn", source="paper sec VI-A (CIFAR-10)",
    n_layers=2, d_model=64, d_ff=384, vocab=10,
))
