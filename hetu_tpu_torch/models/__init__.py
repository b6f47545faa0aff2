from .gpt import (GPTConfig, GPTLMHeadModel, GPTModel, llama3_8b_config,
                  llama_config)

__all__ = ["GPTConfig", "GPTLMHeadModel", "GPTModel", "llama_config",
           "llama3_8b_config"]
