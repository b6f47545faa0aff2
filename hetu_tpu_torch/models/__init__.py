from .gpt import GPTConfig, llama3_8b_config, llama_config

__all__ = ["GPTConfig", "llama_config", "llama3_8b_config"]
