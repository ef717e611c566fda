from .pipeline import SyntheticLM
