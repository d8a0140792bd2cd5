from .questions import (QuestionPairGenerator, WorkloadGenerator,
                        synthesize_response)
