"""PyTorch/CUDA port of ``opentransformer_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here keeps
its counterpart's relative path and names, takes the same weights
(``compat.params_from_jax``) and is held against it by
``tests/test_torch_*.py``. The port imports ``torch`` and numpy only — no
JAX, flax, yaml, and nothing from the JAX package.

Ported so far: the speech2text decode side (conv frontend, transformer
encoder, KV-cached decoder, batched beam and greedy search), the transformer
and LSTM language models with shallow fusion and n-best rescoring, the eval
CLI, training speech2text from raw waveforms (the online dataset and
loader, the device feature stage, label smoothing, Adam/SGD with the seven
schedules, per-epoch checkpoints, ``cli/run.py`` on JSON configs), and CTC:
the loss (optax's recursion), the CTC head with its look-ahead conv, the
hybrid loss, the ``ctc`` model, greedy and native prefix-beam CTC decoding
with n-gram fusion, and joint CTC/attention rescoring; and the Conformer
family (rel-pos attention, the conv module, conformer blocks and encoders,
chunked attention encoded offline, the concat frontend, BatchNorm conv
modules); and streaming and serving: the streamed encode
(``encode_step`` with per-block KV caches and causal-conv state), the
online CTC and attention recognizers, the long-form (windowed) recognizer,
the multi-stream server core and ``cli/serve.py`` (dynamic batcher, TCP
lines, streaming TCP and PCM); and the transducer's inference and serving
(prediction and joint networks, greedy and mAES beam decoding with LM
fusion, the online and multi-stream transducer recognizers, the eval and
serve CLIs); and the anchor recipe: the kaldi feature dataset with
load-time noise, the bucketing sampler, the device-resident corpus, bf16
autocast, ``steps_per_exec``, CLI training with the hybrid CTC loss, the
per-epoch dev greedy-CER probe and checkpoint averaging (``cli/average.py``);
and training every model family the port decodes: the RNN-T loss
(``ops/rnnt_loss.py``) and the transducer's blocked joint, BatchNorm conv
modules in training (flax's batch statistics), ``ctc`` models and both
language models in the training CLI (the text dataset and collate), and
an LM checkpoint directory for the eval CLI's ``-lm``; and the reference
user's round trip: reference OpenTransformer ``.pt`` checkpoints in and
out (``compat``; the reference transformer's ``concat_after`` and
``front_end_layer_norm``, ``scan_layers`` checkpoints), the eval and serve
CLIs' ``-m``/``-c``/``-d`` interface, resumed (``-ct``, ``-ios``) and
supervised training with asynchronous saves, MixSpeech, the fused update,
the bfloat16 first moment, the psf extractor, host ``gaussian_noise`` and
the ESPnet dataset; and the mixture-of-experts feed-forward
(``models/modules.py:MoEFeedForward``) in both encoders and the
transformer LM, trained with its load-balance loss and streamed; and
parallelism on ``torch.distributed`` (``parallel/``): data, tensor,
pipeline (``sharded`` and 1F1B) and expert parallelism in the training CLI,
and ``-n`` in the eval CLI.

The Pallas kernels of the JAX package become hand-written CUDA kernels
under ``csrc/``, built with ``nvcc`` at first use (``ops/cuda_build.py``):
the fused projection → log-softmax → top-k of a decode step
(``project_topk.cu``), its two-head form for LM fusion
(``project2_topk.cu``) and the fused DFT → power → mel → log of the
training feature stage (``fbank_spec_mel.cu``). One more kernel replaces
no Pallas kernel: the beam step's attention over its cross and self
caches (``beam_attention.cu``, ``ops/beam_attention.py``), which reads the
caches in place where PyTorch's eager form of the JAX package's einsums
cast, copied and gathered them every step. Each kernel has a plain
PyTorch version beside it, which is what runs for tensors on the CPU.
"""

__version__ = "0.1.0"
