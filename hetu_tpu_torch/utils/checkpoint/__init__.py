"""Checkpoints of the port (``hetu_tpu.utils.checkpoint`` counterpart):
safetensors files read and written without the ``safetensors`` package,
and the HF GPT-2 / Megatron converters."""
from .converters import (hf_gpt2_to_ht, ht_to_hf_gpt2,
                         interleaved_qkv_to_megatron,
                         megatron_qkv_to_interleaved)
from .safetensors_io import (RESTORE_LOG, AsyncSaveHandle, WriterDeathError,
                             arm_kill_mid_write, disarm_kill_mid_write,
                             load_checkpoint, load_model, load_split,
                             read_model, read_safetensors,
                             restore_records, save_checkpoint, save_model,
                             save_split, save_split_async, write_safetensors)

__all__ = ["AsyncSaveHandle", "RESTORE_LOG", "WriterDeathError",
           "arm_kill_mid_write", "disarm_kill_mid_write", "hf_gpt2_to_ht",
           "ht_to_hf_gpt2", "interleaved_qkv_to_megatron", "load_checkpoint",
           "load_model", "load_split", "megatron_qkv_to_interleaved",
           "read_model", "read_safetensors", "restore_records", "save_checkpoint",
           "save_model", "save_split", "save_split_async",
           "write_safetensors"]
