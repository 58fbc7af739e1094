"""Joint data and label optimization, the original DLG (Zhu et al.; counterpart of
``breaching_tpu/attacks/optimization_with_label_attack.py``).

The candidate tree gains a ``labels`` leaf of label logits, (N, classes) for
classification or one row of token logits per position (N, T, vocab) for a sequence task
(causal or masked LM), drawn standard normal after the data; the task loss takes their
softmax as soft labels.
L-BFGS flattens the data, then the labels, as ``ravel_pytree`` orders the JAX
package's dict; the box applies to the data only. Adam gives the label leaf the same
step tail with the box off, a second ``adam_box_step`` launch that shares the step's
loss and best value. The reconstruction's labels are the logits' argmax.
"""

from __future__ import annotations

import torch

from .optimization_based_attack import OptimizationBasedAttacker


class OptimizationJointAttacker(OptimizationBasedAttacker):
    """Optimizes candidate data and soft labels jointly."""

    supports_fleet = False  # the fleet stacks experiments' labels; here they are optimized

    def reconstruct(self, server_payload, shared_data, server_secrets=None,
                    initial_data=None, dryrun=False):
        if shared_data[0]["metadata"]["labels"] is not None:
            raise ValueError("Joint optimization only makes sense if no labels are provided. "
                             "Switch to attack.attack_type=optimization instead.")
        metadata = server_payload[0]["metadata"]
        self._task = metadata.get("task", "classification")
        self._num_classes = metadata.get("classes")
        self._vocab_size = metadata.get("vocab_size")
        return super().reconstruct(server_payload, shared_data, server_secrets, initial_data, dryrun)

    def _recover_label_information(self, user_data, rec_models=None):
        return None  # the labels are optimized

    def _init_candidate_tree(self, num_trials, num_points):
        tree = super()._init_candidate_tree(num_trials, num_points)
        if self._task == "classification":
            shape = (num_trials, num_points, int(self._num_classes))
        else:  # sequence tasks: soft tokens at every position
            shape = (num_trials, num_points, int(self.data_shape[0]), int(self._vocab_size))
        tree["labels"] = self._initialize_labels(shape)
        return tree

    def _initialize_labels(self, shape):
        return torch.randn(shape, generator=self.setup["generator"],
                           dtype=self.setup["dtype"]).to(self.setup["device"])

    def _effective_labels(self, tree, labels):
        return torch.softmax(tree["labels"], dim=-1)

    def _extract_solution(self, tree, labels):
        return dict(data=tree["data"], labels=torch.argmax(tree["labels"], dim=-1))
