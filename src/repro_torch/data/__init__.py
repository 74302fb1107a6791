from .synthetic import SyntheticLMDataset
