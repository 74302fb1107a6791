from .synthetic import SyntheticLMDataset, synthetic_images
