from .bert import (BertConfig, BertForPreTraining,
                   BertForSequenceClassification, BertModel)
from .cnn import BasicBlock, ResNet, SimpleCNN, resnet18, resnet34
from .ctr import DCN, DeepFM, WDL, ctr_loss
from .gpt import (GPTConfig, GPTLMHeadModel, GPTModel, draft_config,
                  draft_state_from, llama3_8b_config, llama_config,
                  mla_config, mla_state_from)
from .rnn import GRU, LSTM, RNN, RNNLanguageModel

__all__ = ["GPTConfig", "GPTLMHeadModel", "GPTModel", "llama_config",
           "llama3_8b_config", "mla_config", "mla_state_from",
           "draft_config", "draft_state_from",
           "BertConfig", "BertModel", "BertForPreTraining",
           "BertForSequenceClassification",
           "SimpleCNN", "ResNet", "BasicBlock", "resnet18", "resnet34",
           "WDL", "DeepFM", "DCN", "ctr_loss",
           "RNN", "GRU", "LSTM", "RNNLanguageModel"]
