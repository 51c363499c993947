from repro_torch.data.pipeline import BatchSpec, EmbeddingPipeline, TokenPipeline
from repro_torch.data.synthetic import NOISE_STD, FederatedDataset, generate

__all__ = ["FederatedDataset", "generate", "NOISE_STD",
           "BatchSpec", "TokenPipeline", "EmbeddingPipeline"]
