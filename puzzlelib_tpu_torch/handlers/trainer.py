"""Training handler (counterpart of ``puzzlelib_tpu/handlers/trainer.py``):
per mini-batch, the forward pass, the cost's gradient, the backward pass
into cleared gradient buffers and one optimizer update."""

from puzzlelib_tpu_torch.handlers.handler import Handler


class Trainer(Handler):
    def __init__(self, mod, cost, optimizer, onBatchFinish=None, batchsize=128):
        super().__init__(mod, onBatchFinish, batchsize)

        self.cost = cost
        self.optimizer = optimizer

    def trainFromHost(self, data, target, macroBatchSize=10000, onMacroBatchFinish=None, random=True):
        self.cost.resetAccumulator()

        self.module.trainMode()
        self.handleFromHost([data, target], None, macroBatchSize, onMacroBatchFinish, random=random)

    def train(self, data, target, random=True):
        self.cost.resetAccumulator()

        self.module.trainMode()
        self.handle([data, target], None, random=random)

    def handleBatch(self, batch, idx, state):
        data, target = batch

        grad = self.cost(self.module(data), target, queryError=False)

        self.optimizer.zeroGradParams()
        self.module.backward(grad, updGrad=False)
        self.optimizer.update()
