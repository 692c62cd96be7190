"""The paper's OWN model family: ResNet (He et al. 2016) for the faithful
reproduction path (Tables 1-3, Fig. 2).  A compact CIFAR-style ResNet
exercising exactly the paper's four Fig. 1 cases (conv, conv+ReLU,
residual+ReLU, residual w/o ReLU) and BN folding.

A copy of ``repro.configs.resnet_paper``.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet-paper"
    stages: tuple = (16, 32, 64)   # channels per stage
    blocks_per_stage: int = 2
    n_classes: int = 10
    img_size: int = 32
    n_bits: int = 8
    tau: int = 4


CONFIG = ResNetConfig()
SMOKE_CONFIG = ResNetConfig(stages=(8, 16), blocks_per_stage=1, img_size=16)
