from repro_torch.data.pipeline import BatchSpec, EmbeddingPipeline, TokenPipeline
from repro_torch.data.synthetic import NOISE_STD, FederatedDataset, as_sharded_rows, generate

__all__ = ["FederatedDataset", "generate", "as_sharded_rows", "NOISE_STD",
           "BatchSpec", "TokenPipeline", "EmbeddingPipeline"]
