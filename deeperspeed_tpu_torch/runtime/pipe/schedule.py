"""Pipeline schedules as instruction streams (counterpart of
``deeperspeed_tpu/runtime/pipe/schedule.py``, a copy of its plain Python).

A ``PipeSchedule`` yields, per step, the list of instructions one stage
executes: ``TrainSchedule`` is 1F1B, ``InferenceSchedule`` forward-only,
``DataParallelSchedule`` the one-stage degenerate case.  ``GPipeSchedule``
is the port's own: every forward, then every backward, so the inputs a
stage keeps grow with the microbatch count.  Each pipeline stage's process
walks its own stream (``runtime/pipe/engine.py``); the transfers are
point-to-point sends and receives over the ``pp`` group.
"""

from abc import ABC, abstractmethod


class PipeSchedule(ABC):
    """Base schedule: yields lists of PipeInstruction per step
    (reference ``schedule.py:17``)."""

    def __init__(self, micro_batches, stages, stage_id):
        super().__init__()
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = self.stage_id - 1
        self.next_stage = self.stage_id + 1

    @abstractmethod
    def steps(self):
        """Yield a list of :class:`PipeInstruction` for each step in the schedule."""

    def num_pipe_buffers(self):
        return self.micro_batches

    def _valid_micro_batch(self, micro_batch_id):
        return 0 <= micro_batch_id < self.micro_batches

    def _valid_stage(self, stage_id):
        return 0 <= stage_id < self.stages

    @property
    def stage(self):
        return self.stage_id

    @property
    def num_stages(self):
        return self.stages

    @property
    def num_micro_batches(self):
        return self.micro_batches

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.stages - 1

    def _buffer_idx(self, micro_batch_id):
        assert self._valid_micro_batch(micro_batch_id)
        return micro_batch_id % self.num_pipe_buffers()

    def __iter__(self):
        self.it = None
        return self

    def __next__(self):
        if self.it is None:
            self.it = self.steps()
        return next(self.it)


class InferenceSchedule(PipeSchedule):
    """Forward-only pipelining (reference ``schedule.py:135``)."""

    def steps(self):
        total_steps = self.micro_batches + self.stages - 1
        for step_id in range(total_steps):
            cmds = []
            micro_batch_id = step_id - self.stage_id
            if self._valid_micro_batch(micro_batch_id):
                if self.is_first_stage:
                    cmds.append(LoadMicroBatch(self._buffer_idx(micro_batch_id)))
                else:
                    cmds.append(RecvActivation(self._buffer_idx(micro_batch_id)))
                cmds.append(ForwardPass(self._buffer_idx(micro_batch_id)))
                if not self.is_last_stage:
                    cmds.append(SendActivation(self._buffer_idx(micro_batch_id)))
            yield cmds

    def num_pipe_buffers(self):
        return 2


class TrainSchedule(PipeSchedule):
    """1F1B schedule (reference ``schedule.py:189``): steady-state alternates
    one forward and one backward per step, bounding live activations to the
    stage depth."""

    def steps(self):
        prev_micro_batch_id = -1
        total_steps = 2 * (self.micro_batches + self.stages - 1)
        for step_id in range(total_steps):
            micro_batch_id, is_forward = self._step_to_micro_batch(step_id)
            cmds = []

            # transfers, paired with the previous step's compute
            if self._valid_micro_batch(prev_micro_batch_id):
                prev_buffer = self._buffer_idx(prev_micro_batch_id)
                if is_forward:
                    if self._valid_stage(self.prev_stage) and self._valid_micro_batch(
                        prev_micro_batch_id
                    ):
                        cmds.append(SendGrad(prev_buffer))
                else:
                    if self._valid_stage(self.next_stage):
                        cmds.append(SendActivation(prev_buffer))
            if self._valid_micro_batch(micro_batch_id):
                curr_buffer = self._buffer_idx(micro_batch_id)
                if is_forward:
                    if not self.is_first_stage and self._valid_stage(self.prev_stage):
                        cmds.append(RecvActivation(curr_buffer))
                    # first stage loads inputs; last stage loads labels
                    # (reference ``schedule.py:226-228``)
                    if self.is_first_stage or self.is_last_stage:
                        cmds.append(LoadMicroBatch(curr_buffer))
                else:
                    if self._valid_stage(self.next_stage):
                        cmds.append(RecvGrad(curr_buffer))

            # compute
            if self._valid_micro_batch(micro_batch_id):
                curr_buffer = self._buffer_idx(micro_batch_id)
                if is_forward:
                    cmds.append(ForwardPass(curr_buffer))
                else:
                    cmds.append(BackwardPass(curr_buffer))

            # optimizer step at the end
            if step_id == total_steps - 1:
                cmds.append(ReduceTiedGrads())
                cmds.append(ReduceGrads())
                cmds.append(OptimizerStep())

            prev_micro_batch_id = micro_batch_id
            yield cmds

    def num_pipe_buffers(self):
        """Reference ``schedule.py:247``: live buffers shrink for late stages."""
        buffers = min(self.stages - self.stage_id, self.micro_batches)
        return max(2, buffers)

    def _step_to_micro_batch(self, step_id):
        if _is_even(step_id) and _is_even(self.stage_id):
            micro_batch_id = self._even_step_forward_id(step_id)
            is_forward = True
        elif _is_odd(step_id) and _is_odd(self.stage_id):
            micro_batch_id = self._odd_step_forward_id(step_id)
            is_forward = True
        elif _is_even(step_id) and _is_odd(self.stage_id):
            micro_batch_id = self._even_step_backward_id(step_id)
            is_forward = False
        elif _is_odd(step_id) and _is_even(self.stage_id):
            micro_batch_id = self._odd_step_backward_id(step_id)
            is_forward = False
        else:
            raise AssertionError("unreachable")
        return micro_batch_id, is_forward

    def _even_step_forward_id(self, step_id):
        base = step_id // 2
        return int(base - self.stage_id // 2)

    def _odd_step_forward_id(self, step_id):
        base = (step_id - 1) // 2
        return int(base - self.stage_id // 2)

    def _even_step_backward_id(self, step_id):
        base = step_id // 2
        return int(base - self.stages + (self.stage_id + 1) // 2)

    def _odd_step_backward_id(self, step_id):
        base = ((step_id - 1) // 2) - self.stages + 1
        return int(base + self.stage_id // 2)


class DataParallelSchedule(PipeSchedule):
    """Degenerate single-stage schedule (reference ``schedule.py:301``)."""

    def steps(self):
        for step_id in range(self.micro_batches):
            cmds = [LoadMicroBatch(0), ForwardPass(0), BackwardPass(0)]
            if step_id == self.micro_batches - 1:
                cmds.extend([ReduceGrads(), OptimizerStep()])
            yield cmds

    def num_pipe_buffers(self):
        return 1


class GPipeSchedule(PipeSchedule):
    """All forwards, then all backwards (GPipe with flush): stage ``s``
    forwards microbatches ``0 .. M-1`` in order, then backs them up in the
    same order; one buffer a microbatch."""

    def steps(self):
        for mb in range(self.micro_batches):
            cmds = []
            if not self.is_first_stage:
                cmds.append(RecvActivation(mb))
            if self.is_first_stage or self.is_last_stage:
                cmds.append(LoadMicroBatch(mb))
            cmds.append(ForwardPass(mb))
            if not self.is_last_stage:
                cmds.append(SendActivation(mb))
            yield cmds
        for mb in range(self.micro_batches):
            cmds = []
            if not self.is_last_stage:
                cmds.append(RecvGrad(mb))
            cmds.append(BackwardPass(mb))
            if not self.is_first_stage:
                cmds.append(SendGrad(mb))
            if mb == self.micro_batches - 1:
                cmds.extend([ReduceTiedGrads(), ReduceGrads(), OptimizerStep()])
            yield cmds

    def num_pipe_buffers(self):
        return self.micro_batches


class PipeInstruction:
    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for key, val in kwargs.items():
            setattr(self, key, val)

    def __repr__(self):
        args = ", ".join(f"{k}={v!r}" for k, v in self.kwargs.items())
        return f"{self.name}({args})"

    def __eq__(self, other):
        return type(self) is type(other) and self.kwargs == other.kwargs


class OptimizerStep(PipeInstruction):
    pass


class ReduceGrads(PipeInstruction):
    pass


class ReduceTiedGrads(PipeInstruction):
    pass


class BufferOpInstruction(PipeInstruction):
    def __init__(self, buffer_id, **kwargs):
        super().__init__(buffer_id=buffer_id, **kwargs)


class LoadMicroBatch(BufferOpInstruction):
    pass


class ForwardPass(BufferOpInstruction):
    pass


class BackwardPass(BufferOpInstruction):
    pass


class SendActivation(BufferOpInstruction):
    pass


class RecvActivation(BufferOpInstruction):
    pass


class SendGrad(BufferOpInstruction):
    pass


class RecvGrad(BufferOpInstruction):
    pass


def _is_even(x):
    return x % 2 == 0


def _is_odd(x):
    return x % 2 != 0
