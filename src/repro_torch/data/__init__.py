from .questions import (QuestionPairGenerator, WorkloadGenerator,
                        synthesize_response)
from .pretrain import token_stream_batches
